"""Functional core shared by GPCSD1D/GPCSD2D: log-joint builders.

Everything inference needs is assembled here as *pure functions* of a flat
unconstrained parameter vector ``u`` and the trial array ``Y`` — the
jit/grad/vmap-able generalization of the reference's ``obj_fun`` closures
(``/root/reference/src/gpcsd/gpcsd1d.py:153-191``,
``gpcsd2d.py:177-221``).  The same ``log_prob`` powers MAP (no Jacobian,
matching the reference objective), NUTS/ADVI/SMC (with the log-det-Jacobian
of the exp bijector), and prediction.

Trial layout: ``Y`` is ``(ntrials, nx, nt)`` (batch leading);
the classes transpose from the reference's ``(nx, nt, ntrials)`` at the API
boundary.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kronlik
from ..ops.kernels import TEMPORAL_KERNELS
from .params import ParamSet


class ModelFns(NamedTuple):
    """Bundle of pure functions for one model configuration."""

    param_set: ParamSet
    build_ks: Callable  # theta -> (nx, nx) LFP-LFP spatial cov (incl. jitter)
    build_kt: Callable  # theta, t, tprime -> (nt, ntp) summed temporal cov
    build_kt_components: Callable  # theta, t, tprime -> list of (nt, ntp)
    loglik: Callable  # theta, Y -> scalar
    neg_log_joint: Callable  # u, Y -> scalar  (MAP objective, no Jacobian)
    log_prob: Callable  # u, Y -> scalar  (posterior density in u-space)
    full_theta: Callable  # theta -> theta merged with fixed params
    build_factors: Callable  # theta -> KronFactors (eig of Ks, Kt, + noise)
    log_prior_u: Callable  # u -> scalar prior + jacobian (no likelihood)
    # warm-started sampling support: the temporal eigh solved in a caller-
    # supplied orthogonal basis (e.g. the previous leapfrog step's
    # eigenvectors), returning the new basis for the next step.
    build_factors_basis: Callable = None  # theta, basis -> KronFactors
    log_prob_basis: Callable = None  # u, Y, basis -> (scalar, basis_new)
    qt0: object = None  # (nt, nt) initial basis (MAP if available)
    # initial basis aux pytree for log_prob_basis: {"qt": qt0} plus
    # {"qs": qs0} when a MAP-centered spatial basis exists (mixed path)
    basis0: object = None
    # exact heteroscedastic-noise configuration: the factorization's qs is
    # noise-whitened and NON-orthogonal there, so basis-threading consumers
    # (parallel/sharded.py) must pass a carried qs through unpolished,
    # mirroring next_basis below
    het_exact: bool = False


def temporal_param_names(n_components: int):
    return [(f"tm{i}_ell", f"tm{i}_sigma2") for i in range(n_components)]


def build_kt_fns(temporal_kinds, t_data):
    """Temporal covariance stack K_t = sum_i K_t^i (reference
    ``gpcsd1d.py:118-120``); kinds are static strings."""
    t_data = np.asarray(t_data).reshape(-1)

    def build_kt_components(theta: Dict, t=None, tprime=None):
        tt = t_data if t is None else jnp.asarray(t).reshape(-1)
        tp = t_data if tprime is None else jnp.asarray(tprime).reshape(-1)
        out = []
        for i, kind in enumerate(temporal_kinds):
            k = TEMPORAL_KERNELS[kind](
                tt, tp, theta[f"tm{i}_ell"], theta[f"tm{i}_sigma2"]
            )
            out.append(k)
        return out

    def build_kt(theta: Dict, t=None, tprime=None):
        comps = build_kt_components(theta, t, tprime)
        total = comps[0]
        for c in comps[1:]:
            total = total + c
        return total

    return build_kt, build_kt_components


def make_model_fns(
    param_set: ParamSet,
    build_ks,
    temporal_kinds,
    t_data,
    fixed: Dict | None = None,
    fixed_log_prior: float = 0.0,
    precondition: Dict | None = None,
    het_exact: bool = False,
) -> ModelFns:
    """Assemble the function bundle given a spatial-cov builder.

    :param build_ks: ``theta -> (nx, nx)`` including jitter.
    :param fixed: constrained parameter values held constant (e.g. ``fix_R``,
        reference ``gpcsd1d.py:160-162``); merged into every unpacked theta.
    :param fixed_log_prior: constant prior mass of the fixed params — added so
        reported NLLs match the reference, which always sums all priors.
    :param precondition: optional reference theta (typically the MAP).  The
        temporal eigendecomposition is then solved in that theta's fixed
        eigenbasis: ``B = Q0^T Kt(theta) Q0`` is near-diagonal for theta near
        the center, which the float32 policy's refinement sweeps exploit.
        Exact for all theta (the similarity transform changes nothing but
        the starting point).
    :param het_exact: with per-channel sig2n, use the exact noise-whitened
        factorization instead of the reference's eigenbasis approximation
        (SURVEY.md §5; ``kronlik.comp_eig_d``); no-op for scalar noise.
    """
    build_kt, build_kt_components = build_kt_fns(temporal_kinds, t_data)
    fixed = dict(fixed or {})

    def _full(theta: Dict) -> Dict:
        return {**theta, **fixed} if fixed else theta

    q0t = None
    q0s = None
    if precondition is not None:
        theta0 = _full({k: jnp.asarray(v) for k, v in precondition.items()})
        fac0 = kronlik.comp_eig_d(
            build_ks(theta0), build_kt(theta0), theta0["sig2n"]
        )
        q0t = jnp.asarray(fac0.qt)  # concrete constant basis
        # Spatial preconditioning is off by default (config.Policy): the
        # congruence refinement needs many convergence-gated sweeps at
        # leapfrog-sized parameter moves.  _eigh_mixed_b and the dict
        # {qt, qs} basis aux remain available and tested.
        from .. import config as _config

        if _config.get_policy().spatial_precondition:
            if not (het_exact and jnp.ndim(theta0["sig2n"])):
                q0s = jnp.asarray(fac0.qs)

    def build_factors(theta: Dict):
        theta = _full(theta)
        Ks = build_ks(theta)
        Kt = build_kt(theta)
        if q0t is not None:
            return kronlik.comp_eig_d_preconditioned(
                Ks, Kt, theta["sig2n"], q0t, het_exact=het_exact, q0s=q0s
            )
        return kronlik.comp_eig_d(Ks, Kt, theta["sig2n"], het_exact=het_exact)

    def loglik(theta: Dict, Y):
        return kronlik.loglik(build_factors(theta), Y)

    def neg_log_joint(u, Y):
        theta = param_set.unpack(u)
        return -(loglik(theta, Y) + param_set.log_prior(theta) + fixed_log_prior)

    def log_prob(u, Y):
        theta = param_set.unpack(u)
        return (
            loglik(theta, Y)
            + param_set.log_prior(theta)
            + fixed_log_prior
            + param_set.log_det_jacobian(u)
        )

    def log_prior_u(u):
        theta = param_set.unpack(u)
        return (
            param_set.log_prior(theta)
            + fixed_log_prior
            + param_set.log_det_jacobian(u)
        )

    def _split_basis(basis):
        """Basis aux pytree: a dict ``{"qt": ..., "qs": ...}`` (qs optional)
        or, backward-compatibly, a bare (nt, nt) array meaning qt only."""
        if isinstance(basis, dict):
            return basis["qt"], basis.get("qs")
        return basis, None

    def build_factors_basis(theta: Dict, basis, qs_basis=None):
        """Factorization with the temporal (and, when carried, spatial)
        eigh warm-started in ``basis`` (the trajectory-threading variant of
        ``precondition``: NUTS carries the previous leapfrog's eigenbases,
        so the congruences are near-diagonal at *every* step regardless of
        how far the chain has drifted from the MAP).  Exact for any
        orthogonal basis; the basis is a numerical hint only, so it is
        detached from differentiation."""
        theta = _full(theta)
        qt_b, qs_b = _split_basis(basis)
        if qs_basis is not None:  # legacy positional form
            qs_b = qs_basis
        qb = jax.lax.stop_gradient(jnp.asarray(qt_b))
        qsb = (
            jax.lax.stop_gradient(jnp.asarray(qs_b)) if qs_b is not None
            else q0s
        )
        return kronlik.comp_eig_d_preconditioned(
            build_ks(theta), build_kt(theta), theta["sig2n"], qb,
            het_exact=het_exact, q0s=qsb,
        )

    def next_basis(fac, basis, theta):
        """Polished basis aux for the next evaluation, mirroring the input
        structure.  The spatial slot is only advanced when the factorization
        actually produced an orthogonal spatial basis (the exact-het path's
        ``qs`` is noise-whitened and non-orthogonal, so there the carried
        basis passes through unchanged)."""
        new_qt = jax.lax.stop_gradient(kronlik.orth_polish(fac.qt))
        if not isinstance(basis, dict):
            return new_qt
        new = {"qt": new_qt}
        if "qs" in basis:
            if het_exact and jnp.ndim(_full(theta)["sig2n"]):
                new["qs"] = basis["qs"]
            else:
                new["qs"] = jax.lax.stop_gradient(kronlik.orth_polish(fac.qs))
        return new

    def log_prob_basis(u, Y, basis):
        theta = param_set.unpack(u)
        fac = build_factors_basis(theta, basis)
        lp = (
            kronlik.loglik(fac, Y)
            + param_set.log_prior(theta)
            + fixed_log_prior
            + param_set.log_det_jacobian(u)
        )
        return lp, next_basis(fac, basis, theta)

    nt = np.asarray(t_data).reshape(-1).size
    qt0 = q0t if q0t is not None else jnp.eye(nt)

    return ModelFns(
        param_set=param_set,
        build_ks=build_ks,
        build_kt=build_kt,
        build_kt_components=build_kt_components,
        loglik=loglik,
        neg_log_joint=neg_log_joint,
        log_prob=log_prob,
        full_theta=_full,
        build_factors=build_factors,
        log_prior_u=log_prior_u,
        build_factors_basis=build_factors_basis,
        log_prob_basis=log_prob_basis,
        qt0=qt0,
        basis0=(
            {"qt": qt0, "qs": q0s} if q0s is not None else {"qt": qt0}
        ),
        het_exact=het_exact,
    )


def posterior_predict(fns: ModelFns, theta: Dict, Y, kphig=None, kphi=None,
                      t_data=None, t_star=None):
    """Factored posterior mean prediction per temporal component.

    Returns dict with optional keys 'csd', 'lfp', each a tuple
    ``(total, per_component_list)`` with arrays (ntrials, nz, ntstar).
    Mirrors reference ``GPCSD1D.predict`` (``gpcsd1d.py:248-293``) but via
    :func:`gpcsd_tpu.ops.kronlik.kron_solve` — no dense Kronecker ever forms.
    """
    fac = fns.build_factors(theta)
    V = kronlik.kron_solve(fac, Y)
    kt_stars = fns.build_kt_components(theta, t=t_data, tprime=t_star)
    out = {}
    for name, kxz in (("csd", kphig), ("lfp", kphi)):
        if kxz is None:
            continue
        comps = [kronlik.kron_cross_mean(kxz, kts, V) for kts in kt_stars]
        total = comps[0]
        for c in comps[1:]:
            total = total + c
        out[name] = (total, comps)
    return out


def posterior_variance(fns: ModelFns, theta: Dict, kxz, prior_spatial_diag,
                       t_data, t_star):
    """Pointwise posterior variance of the (total) latent field at the
    prediction grid — a capability the reference lacks entirely (it returns
    only posterior means).

    Fully factored: with cross-covariance ``c = kxz[:, i] (x) ktt[:, j]``,

        var_ij = prior_ij - sum_ab (Qs^T kxz)_ai^2 (Qt^T ktt)_bj^2 / D_ab

    i.e. two small congruences plus one (nx, nt) x (nt, ntstar) matmul chain
    — never the (nx*nt)^2 joint covariance.

    :param kxz: (nx, nz) spatial cross-covariance to the target field
    :param prior_spatial_diag: (nz,) prior spatial variance at the targets
    :return: (nz, ntstar) variance array
    """
    import jax.numpy as jnp

    theta_f = fns.full_theta(theta)
    fac = fns.build_factors(theta)
    kt_stars = fns.build_kt_components(theta, t=t_data, tprime=t_star)
    ktt = kt_stars[0]
    for k in kt_stars[1:]:
        ktt = ktt + k
    # prior temporal variance at t_star (sum of component variances)
    kt_star_diag = 0.0
    for i, k in enumerate(fns.build_kt_components(theta, t=t_star, tprime=t_star)):
        kt_star_diag = kt_star_diag + jnp.diagonal(k)
    prior = jnp.asarray(prior_spatial_diag)[:, None] * kt_star_diag[None, :]

    As = jnp.square(fac.qs.T @ jnp.asarray(kxz))  # (nx, nz)
    At = jnp.square(fac.qt.T @ ktt)  # (nt, ntstar)
    quad = As.T @ (1.0 / fac.d) @ At  # (nz, ntstar)
    return prior - quad
