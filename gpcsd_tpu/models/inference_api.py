"""High-level inference API shared by GPCSD1D and GPCSD2D.

Extends the reference's class surface (which only has ``fit``,
``gpcsd1d.py:130-246``) with full posterior inference over hyperparameters —
NUTS, ADVI, and SMC on the same log-joint, returning *constrained* per-name
samples so downstream analysis never touches the unconstrained space.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class PosteriorSamples(NamedTuple):
    """Posterior over hyperparameters in constrained (natural) units."""

    theta: Dict[str, np.ndarray]  # name -> (..., nsamples[, size]) samples
    raw: object  # backend-specific result (NUTSResult/ADVIResult/SMCResult)
    diagnostics: Dict[str, np.ndarray]


class InferenceAPIMixin:
    """Mixin adding .sample_posterior / .advi / .smc to model classes.

    Host classes must provide ``_fns(fix_R=...)``, ``_Y()``, ``_theta()``,
    ``_set_theta(theta)``.
    """

    def _constrain_batch(self, fns, u_batch):
        """(N, dim) unconstrained -> dict of (N,) or (N, size) arrays."""
        theta = jax.vmap(fns.param_set.unpack)(jnp.asarray(u_batch))
        return {k: np.asarray(v) for k, v in theta.items()}

    def sample_posterior(
        self,
        n_chains=4,
        num_warmup=500,
        num_samples=500,
        seed=0,
        fix_R=False,
        max_depth=10,
        target_accept=0.8,
        mesh=None,
        set_posterior_mean=False,
        precondition=True,
        chunk_size=None,
        pool_warmup=False,
        state_path=None,
        warm_basis=False,
        callback=None,
        init="params_jitter",
        save_every=1,
        laplace=None,
        laplace_hessian=None,
        dense_mass=False,
        reparam=None,
    ) -> PosteriorSamples:
        """NUTS posterior over hyperparameters.

        :param mesh: optional jax Mesh with (chain, trial) axes — runs the
            multi-device path (:func:`gpcsd_tpu.parallel.sharded.nuts_sharded`)
            with the same initialization and whitening; otherwise chains are
            vmapped on one device.
        :param set_posterior_mean: write posterior-mean params back into the
            model (analogous to ``fit`` writing back the MAP).
        :param precondition: solve the temporal eigh in the current
            parameters' eigenbasis (run ``fit`` first so this is the MAP);
            exact everywhere, and what the float32 policy's refinement
            sweeps start from (see ``make_model_fns``).
        :param pool_warmup: share mass-matrix adaptation statistics across
            chains at chunk boundaries (chunked driver only).
        :param chunk_size: run the sampler as a host loop over jitted
            chunks of this many transitions (:func:`nuts_chains_chunked`)
            instead of one jitted program.  Needed for ``pool_warmup``,
            ``state_path`` and ``callback``.
        :param state_path: chunk-level checkpoint/resume file (chunked
            driver only) — rerunning after a crash continues from the last
            completed chunk.
        :param callback: ``callback(chunk_index, carry)`` after every chunk
            (chunked driver only) — progress reporting / per-chunk timing.
        :param warm_basis: thread the temporal eigenbasis along each NUTS
            trajectory (every leapfrog solves its eigh in the previous
            step's eigenvectors).  Pays only with the float32 policy's
            refinement sweeps — LAPACK / cuSOLVER ``eigh`` ignores warm
            starts — so off by default.  Exact everywhere.
        :param init: chain initialization. ``"params_jitter"`` (default)
            starts chains at the model's current parameters (run ``fit``
            first so this is the MAP) with a small per-chain jitter in
            unconstrained space; ``"prior"`` draws starts from the priors.
            Prior draws can sit millions of log-units from the posterior
            bulk at real problem sizes (the Ks quadrature amplitude
            convention makes prior-scale temporal variances astronomically
            wrong), and warmup spent descending that cliff diverges
            constantly and poisons step-size adaptation.
        :param laplace: sample in the MAP-Hessian-whitened space
            ``u = u0 + H^{-1/2} v`` (Laplace preconditioning; run ``fit``
            first so the center is the MAP).  The hyperparameter posterior
            at real data sizes is a strongly-correlated razor ridge that a
            DIAGONAL mass matrix cannot whiten (chains collapse their step
            size and saturate the tree-depth cap).  Whitening by the dense
            MAP Hessian makes the posterior near-isotropic.  Exact (constant
            linear reparameterization).  Default None = on.
        :param laplace_hessian: precomputed Hessian of the negative log
            joint at the current parameters — a (dim, dim) array or a path
            to an ``.npz`` with key ``H`` (see ``scripts/laplace_hessian.py``).
            Without it the Hessian is computed in process by forward-over-
            reverse AD, or by central finite differences of the gradient
            when AD gives non-finite entries.
        :param dense_mass: adapt a FULL-covariance metric during warmup
            (Stan dense_e analog) instead of the diagonal one.  Composes
            with ``laplace``: whitening supplies the static linear map,
            the dense metric learns the residual correlations the
            whitening missed (building blocks in
            ``infer/dense_metric.py``).
        :param reparam: ``"amplitude"`` samples in coordinates where the
            model's mean per-channel LFP signal variance is an axis
            (``models/reparam.py``) — removing the curved forward-
            amplitude ridge (R vs temporal sigma2 gain trade-off) at the
            source instead of absorbing it into the metric.  The map is
            a closed-form unimodular bijection, so the sampled density
            needs no Jacobian correction; whitening and the dense metric
            compose on top.  Chunked/vmapped single-device paths only.
        """
        fns = self._fns(fix_R=fix_R, precondition=precondition)
        Y = self._Y()
        key = jax.random.PRNGKey(seed)

        if mesh is not None:
            # the sharded driver has no chunking/pooling/checkpointing —
            # refuse rather than silently dropping what the caller asked for
            ignored = {
                "pool_warmup": pool_warmup,
                "state_path": state_path,
                "chunk_size": chunk_size,
                "callback": callback,
                "reparam": reparam,
            }
            bad = [k for k, v in ignored.items() if v]
            if bad:
                raise ValueError(
                    f"sample_posterior(mesh=...) does not support {bad}; "
                    "these are chunked-driver (single-device) options"
                )
        if laplace is None:
            laplace = True

        u_center = jnp.asarray(fns.param_set.pack(self._theta()))
        if reparam == "amplitude":
            from .reparam import AmplitudeReparam

            reparam_t = AmplitudeReparam(fns)
            to_r, from_r = reparam_t.forward, reparam_t.inverse
        elif reparam:
            raise ValueError(f"unknown reparam {reparam!r}")
        else:
            reparam_t = None
            to_r = from_r = lambda x: x
        r_center = jnp.asarray(to_r(u_center))
        if laplace:
            # dense MAP-Hessian whitening: sample v with
            # u = u_center + A v,  A = H^{-1/2} (SPD from the floored
            # eigendecomposition; directions of non-positive curvature
            # get the scale of the stiffest mode / 1e8)
            H = None
            if laplace_hessian is not None:
                if isinstance(laplace_hessian, (str, bytes)):
                    with np.load(laplace_hessian) as d:
                        H = np.asarray(d["H"], dtype=np.float64)
                else:
                    H = np.asarray(laplace_hessian, dtype=np.float64)
                dim = int(u_center.shape[0])
                if H.shape != (dim, dim):
                    raise ValueError(
                        f"laplace_hessian has shape {H.shape}, "
                        f"expected ({dim}, {dim})"
                    )
                H = jnp.asarray(H)
            if H is None:
                H = jax.jit(
                    jax.hessian(lambda u: fns.neg_log_joint(u, Y))
                )(u_center)
                if not bool(jnp.isfinite(H).all()):
                    H = None
            if H is None:  # central finite differences of the gradient,
                # all 2*dim stencil points in one batched call
                h = 1e-4
                dim = u_center.shape[0]
                eye = h * jnp.eye(dim, dtype=u_center.dtype)
                pts = jnp.concatenate(
                    [u_center[None] + eye, u_center[None] - eye], axis=0
                )
                gs = jax.jit(
                    jax.vmap(jax.grad(lambda u: fns.neg_log_joint(u, Y)))
                )(pts)
                H = ((gs[:dim] - gs[dim:]) / (2 * h)).T
            H = 0.5 * (H + H.T)
            if reparam_t is not None:
                # pull the u-space Hessian back to reparam space:
                # H_r = J^T H J with J = du/dr at the center (the
                # transform is unimodular, so there is no log-det
                # curvature term; the gradient term vanishes at the
                # mode to the same order the Laplace whitening already
                # assumes)
                J = np.asarray(
                    jax.jacobian(from_r)(r_center), dtype=np.float64
                )
                H = J.T @ np.asarray(H, dtype=np.float64) @ J
            w, V = np.linalg.eigh(np.asarray(H, dtype=np.float64))
            # saddle-free treatment: use |curvature| so directions of
            # negative curvature (center not exactly the mode) get their
            # actual scale rather than an astronomically wide one, with
            # a relative floor for genuinely flat directions
            wmax = float(np.max(np.abs(w)))
            w = np.maximum(np.abs(w), 1e-6 * max(wmax, 1e-30))
            A = jnp.asarray((V * (1.0 / np.sqrt(w))[None, :]) @ V.T,
                            u_center.dtype)
            A_inv = jnp.asarray((V * np.sqrt(w)[None, :]) @ V.T,
                                u_center.dtype)

            def to_u(v):
                return from_r(r_center + A @ v)

            def from_u(u):
                return A_inv @ (to_r(u) - r_center)
        else:
            def to_u(v):
                return from_r(v)

            def from_u(u):
                return to_r(u)

        v0s = []
        if init == "params_jitter":
            # in whitened space the posterior sd is ~1, so unit-scale
            # jitter gives properly overdispersed starts; unwhitened
            # falls back to small u-space jitter
            scale = 1.0 if laplace else 0.05
            for k in jax.random.split(jax.random.fold_in(key, 0), n_chains):
                v = from_u(u_center) + scale * jax.random.normal(
                    k, u_center.shape, u_center.dtype
                )
                # keep starts inside the parameter box (clip in u-space)
                v0s.append(from_u(fns.param_set.clip_to_bounds(to_u(v))))
        elif init == "prior":
            for k in jax.random.split(jax.random.fold_in(key, 0), n_chains):
                theta0 = fns.param_set.sample(k)
                u = fns.param_set.clip_to_bounds(fns.param_set.pack(theta0))
                v0s.append(from_u(jnp.asarray(u)))
        else:
            raise ValueError(f"unknown init {init!r}")

        if mesh is not None:
            from ..parallel.sharded import nuts_sharded

            res = nuts_sharded(
                fns, np.asarray(Y), mesh, key,
                n_chains=n_chains, num_warmup=num_warmup,
                num_samples=num_samples, max_depth=max_depth,
                target_accept=target_accept,
                warm_basis=bool(warm_basis),
                dense_mass=dense_mass,
                u0s=jnp.stack(v0s),
                to_u=to_u,
            )
        else:
            from ..infer.nuts import nuts_chains, nuts_chains_chunked

            warm_kw = {}
            if warm_basis:
                # thread BOTH eigenbases (temporal + spatial, when a MAP
                # spatial basis exists) along trajectories
                warm_kw = dict(
                    log_prob_aux=lambda v, qb: fns.log_prob_basis(to_u(v), Y, qb),
                    aux0=jax.tree_util.tree_map(jnp.asarray, fns.basis0),
                )
            if chunk_size:
                res = nuts_chains_chunked(
                    lambda v: fns.log_prob(to_u(v), Y),
                    jnp.stack(v0s),
                    jax.random.fold_in(key, 1),
                    num_warmup=num_warmup,
                    num_samples=num_samples,
                    max_depth=max_depth,
                    target_accept=target_accept,
                    chunk_size=chunk_size,
                    pool_warmup=pool_warmup,
                    state_path=state_path,
                    save_every=save_every,
                    callback=callback,
                    dense_mass=dense_mass,
                    **warm_kw,
                )
            else:
                res = jax.jit(
                    lambda v0s, k: nuts_chains(
                        lambda v: fns.log_prob(to_u(v), Y),
                        v0s,
                        k,
                        num_warmup=num_warmup,
                        num_samples=num_samples,
                        max_depth=max_depth,
                        target_accept=target_accept,
                        dense_mass=dense_mass,
                        **warm_kw,
                    )
                )(jnp.stack(v0s), jax.random.fold_in(key, 1))
        if reparam_t is not None:
            # nonlinear map back to u-space (whitened or not)
            res = res._replace(
                samples=np.asarray(
                    jax.jit(jax.vmap(jax.vmap(to_u)))(
                        jnp.asarray(res.samples)
                    )
                )
            )
        elif laplace:
            # map whitened samples back to u-space (A is symmetric)
            res = res._replace(
                samples=np.asarray(res.samples) @ np.asarray(A)
                + np.asarray(u_center)[None, None, :]
            )

        samples = np.asarray(res.samples)
        flat = samples.reshape(-1, samples.shape[-1])
        theta = self._constrain_batch(fns, flat)
        diagnostics = {
            "accept_prob": np.asarray(res.accept_prob),
            "num_steps": np.asarray(res.num_steps),
            "diverging": np.asarray(res.diverging),
            "step_size": np.asarray(res.step_size),
        }
        if samples.ndim == 3 and samples.shape[0] > 1 and samples.shape[1] > 3:
            from ..infer.diagnostics import ess_bulk, ess_tail, rhat

            names = list(fns.param_set.names_flat())
            diagnostics["rhat"] = dict(zip(names, rhat(samples)))
            diagnostics["ess"] = dict(zip(names, ess_bulk(samples)))
            diagnostics["ess_tail"] = dict(zip(names, ess_tail(samples)))
        if set_posterior_mean:
            mean_u = jnp.asarray(flat.mean(axis=0))
            th = fns.param_set.unpack(mean_u)
            th = fns.full_theta(th)
            self._set_theta(th)
        self.posterior = PosteriorSamples(theta=theta, raw=res, diagnostics=diagnostics)
        return self.posterior

    def advi(self, num_steps=3000, n_mc=8, learning_rate=0.02, seed=0, fix_R=False,
             n_draws=1000, mesh=None) -> PosteriorSamples:
        """Mean-field ADVI posterior approximation.

        :param mesh: optional (chain, trial) Mesh — trial terms psum-reduced
            over chips (:func:`gpcsd_tpu.parallel.sharded.advi_sharded`).
        """
        from ..infer.advi import ADVIResult, advi_fit

        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        key = jax.random.PRNGKey(seed)
        if mesh is not None:
            from ..parallel.sharded import advi_sharded

            raw = advi_sharded(
                fns, np.asarray(Y), mesh, key,
                num_steps=num_steps, n_mc=n_mc, learning_rate=learning_rate,
            )
            res = ADVIResult(*raw) if not isinstance(raw, ADVIResult) else raw
            draws = np.asarray(res.sample(jax.random.fold_in(key, 2), n_draws))
            theta = self._constrain_batch(fns, draws)
            self.posterior = PosteriorSamples(
                theta=theta, raw=res,
                diagnostics={"elbo": np.asarray(res.elbo_trace)},
            )
            return self.posterior
        u0 = fns.param_set.clip_to_bounds(
            fns.param_set.pack(fns.param_set.sample(jax.random.fold_in(key, 0)))
        )
        res = jax.jit(
            lambda u0, k: advi_fit(
                lambda u: fns.log_prob(u, Y),
                u0, k, num_steps=num_steps, n_mc=n_mc, learning_rate=learning_rate,
            )
        )(u0, jax.random.fold_in(key, 1))
        draws = np.asarray(res.sample(jax.random.fold_in(key, 2), n_draws))
        theta = self._constrain_batch(fns, draws)
        self.posterior = PosteriorSamples(
            theta=theta,
            raw=res,
            diagnostics={"elbo": np.asarray(res.elbo_trace)},
        )
        return self.posterior

    def smc(self, n_particles=1024, n_mutation_steps=10, seed=0, fix_R=False,
            mesh=None) -> PosteriorSamples:
        """Adaptive tempered SMC posterior (prior -> posterior).

        :param mesh: optional (chain, trial) Mesh — shards particle
            likelihoods over chips (:func:`gpcsd_tpu.parallel.sharded.smc_sharded`).
        """
        fns = self._fns(fix_R=fix_R)
        Y = self._Y()
        key = jax.random.PRNGKey(seed)
        if mesh is not None:
            from ..parallel.sharded import smc_sharded

            res = smc_sharded(
                fns, np.asarray(Y), mesh, key,
                n_particles=n_particles, n_mutation_steps=n_mutation_steps,
            )
            theta = self._constrain_batch(fns, np.asarray(res.particles))
            self.posterior = PosteriorSamples(
                theta=theta,
                raw=res,
                diagnostics={
                    "log_evidence": np.asarray(res.log_evidence),
                    "n_stages": np.asarray(res.n_stages),
                    "acceptance": np.asarray(res.acceptance),
                },
            )
            return self.posterior
        from ..infer.smc import smc_run
        particles0 = []
        for k in jax.random.split(jax.random.fold_in(key, 0), n_particles):
            th = fns.param_set.sample(k)
            particles0.append(fns.param_set.clip_to_bounds(fns.param_set.pack(th)))
        particles0 = jnp.stack(particles0)

        def log_prior(u):
            return fns.log_prior_u(u)

        def log_like(u):
            theta = fns.param_set.unpack(u)
            return fns.loglik(theta, Y)

        res = jax.jit(
            lambda p, k: smc_run(log_prior, log_like, p, k, n_mutation_steps=n_mutation_steps)
        )(particles0, jax.random.fold_in(key, 1))
        theta = self._constrain_batch(fns, np.asarray(res.particles))
        self.posterior = PosteriorSamples(
            theta=theta,
            raw=res,
            diagnostics={
                "log_evidence": np.asarray(res.log_evidence),
                "n_stages": np.asarray(res.n_stages),
                "acceptance": np.asarray(res.acceptance),
            },
        )
        return self.posterior

    def information_criteria(
        self, method="both", max_draws=256, seed=0, batch=8, fix_R=False
    ):
        """Fully-Bayesian model comparison criteria over the stored
        posterior: WAIC and/or PSIS-LOO with per-trial pointwise terms
        (:mod:`gpcsd_tpu.infer.model_comparison`).  Run
        ``sample_posterior`` / ``advi`` / ``smc`` first; works with any of
        them because it reconstructs unconstrained draws from the
        constrained ``posterior.theta`` dict.

        :param method: ``"waic"``, ``"loo"``, or ``"both"``.
        :param max_draws: posterior draws used (subsampled without
            replacement — pointwise likelihood is O(draws * ntrials)).
        :returns: dict with keys among {"waic", "loo"}; LOO includes the
            per-trial Pareto k-hat reliability diagnostic.
        """
        if getattr(self, "posterior", None) is None:
            raise RuntimeError(
                "no posterior stored — run sample_posterior/advi/smc first"
            )
        from ..infer import model_comparison as mc

        fns = self._fns(fix_R=fix_R)
        theta = {
            k: jnp.asarray(v) for k, v in self.posterior.theta.items()
        }
        us = np.asarray(jax.vmap(fns.param_set.pack)(theta))
        n = us.shape[0]
        if n > max_draws:
            idx = np.random.default_rng(seed).choice(n, max_draws, replace=False)
            us = us[idx]
        ll = mc.pointwise_loglik(fns, us, self._Y(), batch=batch)
        out = {"n_draws": int(us.shape[0])}
        if method in ("waic", "both"):
            out["waic"] = mc.waic(ll)
        if method in ("loo", "both"):
            out["loo"] = mc.psis_loo(ll)
        return out
