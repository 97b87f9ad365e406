"""Multi-restart MAP fitting (the reference's only hyperparameter inference).

Reference semantics reproduced (``/root/reference/src/gpcsd/gpcsd1d.py:130-246``):
draw each restart's initial parameters from the priors, run bounded L-BFGS on
the negative log-joint over log-transformed parameters, keep the best
finite-NLL restart.

Two execution paths:
- ``backend='jax'`` (default): restarts are a ``vmap`` batch over the pure
  JAX optimizer in :mod:`gpcsd_tpu.infer.lbfgs` — one compiled program, all
  restarts advance in lockstep on the device.
- ``backend='scipy'``: serial scipy ``L-BFGS-B`` with a jitted
  ``value_and_grad`` oracle — bitwise-faithful to the reference's optimizer
  for cross-checking.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import ParamSet
from .lbfgs import lbfgs_minimize


class MAPResult(NamedTuple):
    u_best: np.ndarray  # best unconstrained parameter vector
    nll_best: float
    nll_values: np.ndarray  # per-restart NLLs (inf for failed restarts)
    u_all: np.ndarray  # (n_restarts, dim)
    messages: list


def sample_restarts(param_set: ParamSet, key, n_restarts: int, fixed=None):
    """Prior draws for restart initialization, packed to u-space and clipped
    into the box (the reference draws can start outside the L-BFGS-B bounds;
    scipy clips internally, we clip explicitly)."""
    u0s = []
    for k in jax.random.split(key, n_restarts):
        theta0 = param_set.sample(k, fixed=fixed)
        u0s.append(param_set.clip_to_bounds(param_set.pack(theta0)))
    return jnp.stack(u0s)


def map_fit(
    neg_log_joint: Callable,
    param_set: ParamSet,
    Y,
    key,
    n_restarts: int = 10,
    backend: str = "jax",
    maxiter: int = 1000,
    gtol: float = 1e-5,
    ftol: float = 1e7 * np.finfo(float).eps,
    verbose: bool = False,
    init_overrides=None,
    chunk_iters: int | None = None,
    state_path: str | None = None,
    max_wall_seconds: float | None = None,
) -> MAPResult:
    """Fit by multi-restart MAP.

    :param neg_log_joint: ``(u, Y) -> scalar`` objective.
    :param init_overrides: optional dict of constrained values to pin at
        initialization (restart draws still randomize the rest).
    :param chunk_iters: drive the batched optimizer in host-synced chunks
        of this many L-BFGS iterations
        (:func:`~gpcsd_tpu.infer.lbfgs.lbfgs_minimize_chunked`) instead of
        one jitted program; implied (4 per chunk) by ``state_path``.
    :param state_path: chunked path — optimizer-state checkpoint after every
        chunk; rerunning the same call resumes from it.
    :param max_wall_seconds: chunked path — pause cleanly (raise
        :class:`~gpcsd_tpu.infer.lbfgs.LBFGSTimeBudget`) at the first chunk
        boundary past this wall-clock budget; rerun to continue.
    """
    lo, hi = param_set.bounds()
    u0s = sample_restarts(param_set, key, n_restarts, fixed=init_overrides)

    if backend == "jax":
        if chunk_iters or state_path or max_wall_seconds is not None:
            from .lbfgs import lbfgs_minimize_chunked

            res = lbfgs_minimize_chunked(
                lambda u: neg_log_joint(u, Y),
                u0s,
                lo=jnp.asarray(lo),
                hi=jnp.asarray(hi),
                max_iter=maxiter,
                gtol=gtol,
                ftol=ftol,
                chunk_iters=chunk_iters or 4,
                state_path=state_path,
                max_wall_seconds=max_wall_seconds,
            )
        else:
            def run_one(u0):
                return lbfgs_minimize(
                    lambda u: neg_log_joint(u, Y),
                    u0,
                    lo=jnp.asarray(lo),
                    hi=jnp.asarray(hi),
                    max_iter=maxiter,
                    gtol=gtol,
                    ftol=ftol,
                )

            res = jax.jit(jax.vmap(run_one))(u0s)
        nlls = np.asarray(res.f)
        nlls = np.where(np.asarray(res.failed), np.inf, nlls)
        u_all = np.asarray(res.u)
        messages = [
            f"converged={bool(c)} iters={int(n)}"
            for c, n in zip(np.asarray(res.converged), np.asarray(res.n_iter))
        ]
    elif backend == "scipy":
        import scipy.optimize

        vg = jax.jit(jax.value_and_grad(lambda u: neg_log_joint(u, Y)))

        def fun(u):
            f, g = vg(jnp.asarray(u))
            return float(f), np.asarray(g, dtype=np.float64)

        sbounds = [
            (None if not np.isfinite(l) else float(l), None if not np.isfinite(h) else float(h))
            for l, h in zip(lo, hi)
        ]
        nlls, u_all, messages = [], [], []
        for u0 in np.asarray(u0s):
            try:
                opt = scipy.optimize.minimize(
                    fun,
                    u0,
                    jac=True,
                    method="L-BFGS-B",
                    bounds=sbounds,
                    options={"maxiter": maxiter, "gtol": gtol, "ftol": ftol},
                )
                nlls.append(opt.fun)
                u_all.append(opt.x)
                messages.append(str(opt.message))
            except ValueError as e:  # pragma: no cover - defensive parity
                nlls.append(np.inf)
                u_all.append(u0)
                messages.append(str(e))
        nlls = np.asarray(nlls)
        u_all = np.asarray(u_all)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    finite = np.isfinite(nlls)
    if not finite.any():
        raise RuntimeError("problem with optimization! (all restarts failed)")
    best = int(np.arange(len(nlls))[finite][np.argmin(nlls[finite])])
    if verbose:
        print("Neg log lik values across different initializations:")
        print(nlls)
        print("Best restart message:", messages[best])
    return MAPResult(
        u_best=u_all[best],
        nll_best=float(nlls[best]),
        nll_values=nlls,
        u_all=u_all,
        messages=messages,
    )
