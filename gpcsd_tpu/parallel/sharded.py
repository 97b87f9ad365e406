"""Sharded inference: trial-parallel likelihood, chain-parallel NUTS/MAP.

This is the distributed-communication layer of the engine (SURVEY.md §2d):
the reference's serial restart loop (``gpcsd1d.py:193``) and per-trial
quad-form loop (``gpcsd1d.py:124-127``) become mesh axes.

Layout:
- mesh axes ``(chain, trial)`` (:func:`gpcsd_tpu.parallel.mesh.make_mesh`)
- Y (ntrials, nx, nt) sharded over ``trial``; each device computes its local
  quadratic-form contribution, reduced with one ``psum`` per likelihood
  evaluation; gradients flow through the psum (reverse-mode of psum is a
  broadcast — zero extra communication).
- Chains/restarts sharded over ``chain`` and vmapped within a device.
- The eigendecompositions are replicated: Ks (nx^2) and Kt (nt^2) are small;
  replicating them costs less than any sharded eigh at these sizes
  (SURVEY.md §5 "long-context": nx<=128, nt<=2500).

All devices along the trial axis see identical psum-reduced log-probs, so
NUTS's data-dependent while-loops stay in lockstep by construction.
"""

from __future__ import annotations

from functools import partial


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.core import ModelFns
from ..ops import kronlik
from .mesh import pad_to_multiple


def make_trial_sharded_log_prob(fns: ModelFns, ntrials_total: int, axis_name: str = "trial"):
    """Build ``(u, Y_local) -> scalar`` log posterior with psum over trials.

    Must be called inside ``shard_map`` over a mesh containing ``axis_name``.
    """

    def log_prob(u, Y_local):
        theta = fns.param_set.unpack(u)
        fac = fns.build_factors(theta)
        alpha = kronlik.whiten(fac, Y_local)
        quad_local = jnp.sum(jnp.square(alpha) / fac.d)
        logdet = ntrials_total * (jnp.sum(jnp.log(fac.d)) + fac.logdet_offset)
        prior = fns.log_prior_u(u)
        # Route every term through ONE psum, dividing replicated terms by the
        # axis size: correct value AND correct reverse-mode gradients (the
        # cotangent of a replicated input would otherwise be summed over the
        # trial devices, overcounting logdet/prior by the axis size).
        nrep = jax.lax.psum(jnp.ones(()), axis_name)
        local = -0.5 * quad_local + (-0.5 * logdet + prior) / nrep
        return jax.lax.psum(local, axis_name)

    return log_prob


def make_trial_sharded_log_prob_aux(
    fns: ModelFns, ntrials_total: int, axis_name: str = "trial"
):
    """Warm-started variant: ``(u, Y_local, qt_basis) -> (scalar, qt_new)``.

    The temporal eigh is solved in the carried basis (NUTS threads the
    previous leapfrog's eigenvectors — ``ModelFns.build_factors_basis``).
    The basis math depends only on ``u``, which is replicated along the
    trial axis, so every trial device computes the identical ``qt_new``
    and the aux state needs no collective.
    """

    def log_prob_aux(u, Y_local, basis):
        theta = fns.param_set.unpack(u)
        fac = fns.build_factors_basis(theta, basis)
        alpha = kronlik.whiten(fac, Y_local)
        quad_local = jnp.sum(jnp.square(alpha) / fac.d)
        logdet = ntrials_total * (jnp.sum(jnp.log(fac.d)) + fac.logdet_offset)
        prior = fns.log_prior_u(u)
        nrep = jax.lax.psum(jnp.ones(()), axis_name)
        local = -0.5 * quad_local + (-0.5 * logdet + prior) / nrep
        lp = jax.lax.psum(local, axis_name)
        new_qt = jax.lax.stop_gradient(kronlik.orth_polish(fac.qt))
        if isinstance(basis, dict):
            new_basis = dict(basis, qt=new_qt)
            if "qs" in basis:
                # mirror core.next_basis: the exact-het qs is noise-whitened
                # and NON-orthogonal — polishing it would corrupt the carried
                # basis, so pass it through unchanged in that configuration
                if fns.het_exact and jnp.ndim(
                    fns.full_theta(theta)["sig2n"]
                ):
                    new_basis["qs"] = basis["qs"]
                else:
                    new_basis["qs"] = jax.lax.stop_gradient(
                        kronlik.orth_polish(fac.qs)
                    )
            return lp, new_basis
        return lp, new_qt

    return log_prob_aux


def nuts_sharded(
    fns: ModelFns,
    Y,
    mesh: Mesh,
    key,
    n_chains: int,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_overrides=None,
    warm_basis: bool = False,
    dense_mass: bool = False,
    u0s=None,
    to_u=None,
):
    """NUTS with chains sharded over the ``chain`` mesh axis and the trial
    likelihood psum-reduced over the ``trial`` axis.

    Returns a :class:`gpcsd_tpu.infer.nuts.NUTSResult` with a leading
    (n_chains,) axis, fully gathered to the host.

    :param u0s: (n_chains, dim) initial positions in the sampling space;
        default one prior draw per chain.
    :param to_u: map from the sampling space to the unconstrained parameter
        vector (e.g. Laplace whitening); default identity.

    :param warm_basis: thread the temporal eigenbasis along trajectories
        (exact everywhere; pays only with the float32 policy's refinement
        sweeps).
    :param dense_mass: adapt a full-covariance metric during warmup (Stan
        dense_e analog); the (dim, dim) metric is per-chain state sharded
        with the chain axis, so the multi-device path needs no extra
        collective.
    """
    from ..infer.nuts import nuts_run

    n_chain_dev = mesh.shape["chain"]
    n_trial_dev = mesh.shape["trial"]
    if n_chains % n_chain_dev:
        raise ValueError(f"n_chains={n_chains} must divide over {n_chain_dev} chain devices")

    Y = np.asarray(Y)
    Y_padded, ntrials = pad_to_multiple(Y, n_trial_dev, axis=0)
    to_u = (lambda v: v) if to_u is None else to_u
    log_prob_u = make_trial_sharded_log_prob(fns, ntrials)
    log_prob_aux_u = (
        make_trial_sharded_log_prob_aux(fns, ntrials) if warm_basis else None
    )
    basis0 = (
        jax.tree_util.tree_map(jnp.asarray, fns.basis0) if warm_basis else None
    )

    def log_prob(v, Y_local):
        return log_prob_u(to_u(v), Y_local)

    def log_prob_aux(v, Y_local, basis):
        return log_prob_aux_u(to_u(v), Y_local, basis)

    if u0s is None:  # prior-draw initial positions, one per chain
        u0s = []
        for k in jax.random.split(jax.random.fold_in(key, 0), n_chains):
            theta0 = fns.param_set.sample(k, fixed=init_overrides)
            u0s.append(fns.param_set.clip_to_bounds(fns.param_set.pack(theta0)))
    u0s = jnp.stack(u0s)
    keys = jax.random.split(jax.random.fold_in(key, 1), n_chains)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("chain"), P("chain"), P("trial")),
        out_specs=P("chain"),
    )
    def run_block(u0_block, key_block, Y_block):
        def one_chain(u0, k):
            warm_kw = {}
            if warm_basis:
                warm_kw = dict(
                    log_prob_aux=lambda u, qb: log_prob_aux(u, Y_block, qb),
                    aux0=basis0,
                )
            return nuts_run(
                lambda u: log_prob(u, Y_block),
                u0,
                k,
                num_warmup=num_warmup,
                num_samples=num_samples,
                max_depth=max_depth,
                target_accept=target_accept,
                dense_mass=dense_mass,
                **warm_kw,
            )

        return jax.vmap(one_chain)(u0_block, key_block)

    return jax.device_get(jax.jit(run_block)(u0s, keys, jnp.asarray(Y_padded)))


def advi_sharded(
    fns: ModelFns,
    Y,
    mesh: Mesh,
    key,
    num_steps: int = 2000,
    n_mc: int = 8,
    learning_rate: float = 0.02,
    init_overrides=None,
):
    """Mean-field ADVI with the trial likelihood psum-reduced over the trial
    axis; the variational state is replicated (tiny), so every device runs
    the identical Adam trajectory."""
    from ..infer.advi import advi_fit

    n_trial_dev = mesh.shape["trial"]
    Y = np.asarray(Y)
    Y_padded, ntrials = pad_to_multiple(Y, n_trial_dev, axis=0)
    log_prob = make_trial_sharded_log_prob(fns, ntrials)

    theta0 = fns.param_set.sample(jax.random.fold_in(key, 0), fixed=init_overrides)
    u0 = fns.param_set.clip_to_bounds(fns.param_set.pack(theta0))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("trial"), P()),
        out_specs=P(),
    )
    def run_block(u0, Y_block, k):
        return advi_fit(
            lambda u: log_prob(u, Y_block),
            u0, k, num_steps=num_steps, n_mc=n_mc, learning_rate=learning_rate,
        )

    return jax.device_get(
        jax.jit(run_block)(u0, jnp.asarray(Y_padded), jax.random.fold_in(key, 1))
    )


def smc_sharded(
    fns: ModelFns,
    Y,
    mesh: Mesh,
    key,
    n_particles: int = 1024,
    n_mutation_steps: int = 10,
    ess_target_frac: float = 0.5,
    rw_scale: float = 1.0,
    init_overrides=None,
):
    """Tempered SMC with particle likelihoods sharded over the chain axis
    and trial terms psum-reduced over the trial axis.

    Particle *state* stays replicated (hyperparameter vectors are tiny);
    only the expensive likelihood evaluations are split across devices and
    re-joined with ``all_gather`` — so the temperature ladder, systematic
    resampling, and evidence accumulation are bitwise identical to the
    single-device :func:`gpcsd_tpu.infer.smc.smc_run`.
    """
    from ..infer.smc import smc_run

    n_chain_dev = mesh.shape["chain"]
    n_trial_dev = mesh.shape["trial"]
    if n_particles % n_chain_dev:
        n_particles += n_chain_dev - (n_particles % n_chain_dev)
    nloc = n_particles // n_chain_dev

    Y = np.asarray(Y)
    Y_padded, ntrials = pad_to_multiple(Y, n_trial_dev, axis=0)
    log_post = make_trial_sharded_log_prob(fns, ntrials)

    def log_prior(u):
        return fns.log_prior_u(u)

    def log_like(u, Y_block):
        # posterior - prior = psum'd likelihood (keeps one implementation)
        return log_post(u, Y_block) - fns.log_prior_u(u)

    particles0 = []
    for k in jax.random.split(jax.random.fold_in(key, 0), n_particles):
        th = fns.param_set.sample(k, fixed=init_overrides)
        particles0.append(fns.param_set.clip_to_bounds(fns.param_set.pack(th)))
    particles0 = jnp.stack(particles0)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P("trial"), P()),
        out_specs=P(),
    )
    def run_block(ps0, Y_block, k):
        def batch_like(ps):
            ci = jax.lax.axis_index("chain")
            local = jax.lax.dynamic_slice_in_dim(ps, ci * nloc, nloc, axis=0)
            lls = jax.vmap(lambda u: log_like(u, Y_block))(local)
            gathered = jax.lax.all_gather(lls, "chain", tiled=True)
            # all devices now hold identical vectors; pmax is a numerical
            # no-op that lets the VMA checker mark the result replicated
            return jax.lax.pmax(gathered, "chain")

        batch_prior = jax.vmap(log_prior)

        return smc_run(
            log_prior,
            lambda u: log_like(u, Y_block),
            ps0,
            k,
            n_mutation_steps=n_mutation_steps,
            ess_target_frac=ess_target_frac,
            rw_scale=rw_scale,
            batch_prior=batch_prior,
            batch_like=batch_like,
        )

    return jax.device_get(jax.jit(run_block)(particles0, jnp.asarray(Y_padded), key))


def map_fit_sharded(
    fns: ModelFns,
    Y,
    mesh: Mesh,
    key,
    n_restarts: int,
    maxiter: int = 1000,
    gtol: float = 1e-5,
    ftol: float = 1e7 * np.finfo(float).eps,
    init_overrides=None,
):
    """Multi-restart MAP with restarts sharded over the chain axis and the
    likelihood psum-reduced over the trial axis.  Returns (u_all, nll_all).
    """
    from ..infer.lbfgs import lbfgs_minimize

    n_chain_dev = mesh.shape["chain"]
    n_trial_dev = mesh.shape["trial"]
    if n_restarts % n_chain_dev:
        n_restarts += n_chain_dev - (n_restarts % n_chain_dev)

    Y = np.asarray(Y)
    Y_padded, ntrials = pad_to_multiple(Y, n_trial_dev, axis=0)
    log_prob = make_trial_sharded_log_prob(fns, ntrials)
    lo, hi = fns.param_set.bounds()

    u0s = []
    for k in jax.random.split(jax.random.fold_in(key, 0), n_restarts):
        theta0 = fns.param_set.sample(k, fixed=init_overrides)
        u0s.append(fns.param_set.clip_to_bounds(fns.param_set.pack(theta0)))
    u0s = jnp.stack(u0s)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("chain"), P("trial")),
        out_specs=(P("chain"), P("chain")),
    )
    def run_block(u0_block, Y_block):
        def one(u0):
            res = lbfgs_minimize(
                lambda u: -log_prob(u, Y_block),
                u0,
                lo=jnp.asarray(lo),
                hi=jnp.asarray(hi),
                max_iter=maxiter,
                gtol=gtol,
                ftol=ftol,
            )
            return res.u, jnp.where(res.failed, jnp.inf, res.f)

        return jax.vmap(one)(u0_block)

    u_all, nll_all = jax.jit(run_block)(u0s, jnp.asarray(Y_padded))
    return jax.device_get(u_all), jax.device_get(nll_all)
