"""Box-constrained L-BFGS in pure JAX (vmappable, jittable).

The reference fits hyperparameters with serial scipy L-BFGS-B restarts
(reference ``src/gpcsd/gpcsd1d.py:193-211``).  Redesign: the
restarts are embarrassingly parallel, so the optimizer itself must be a pure
JAX function — then ``vmap`` turns 10-20 restarts into one batched program
and ``shard_map`` spreads them over devices (SURVEY.md §2d).

Implementation: limited-memory BFGS two-loop recursion with circular history
buffers, Armijo backtracking line search, and box handling by projection
(gradient-projection steps; convergence measured on the projected gradient).
Static shapes and ``lax.while_loop`` only — no data-dependent Python control
flow.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LBFGSTimeBudget(Exception):
    """Raised by :func:`lbfgs_minimize_chunked` when ``max_wall_seconds``
    elapses: the optimizer state is checkpointed (``state_path``) and the
    SAME call resumes from it.  Lets drivers under an external ``timeout``
    stop cleanly between dispatches instead of being killed mid-dispatch."""


class LBFGSResult(NamedTuple):
    u: jnp.ndarray  # final iterate
    f: jnp.ndarray  # final objective
    n_iter: jnp.ndarray
    converged: jnp.ndarray  # True if gradient tolerance met
    failed: jnp.ndarray  # True if objective non-finite at the start


class _State(NamedTuple):
    k: jnp.ndarray
    u: jnp.ndarray
    f: jnp.ndarray
    g: jnp.ndarray
    s_hist: jnp.ndarray  # (m, dim)
    y_hist: jnp.ndarray  # (m, dim)
    rho: jnp.ndarray  # (m,)
    done: jnp.ndarray


def _vma0(ref):
    """A zero scalar carrying ``ref``'s varying-across-mesh type.

    Used to seed zero-initialized loop carries so their types match the
    varying values they accumulate under ``shard_map(..., check_vma=True)``.
    Numerically a no-op.
    """
    return jnp.sum(ref) * 0.0


def _two_loop(g, s_hist, y_hist, rho, k, m):
    """Two-loop recursion over a circular history buffer.

    Slot validity is encoded by rho != 0; invalid slots contribute nothing.
    """
    q = g

    def bwd(i, carry):
        q, alphas = carry
        # iterate newest -> oldest: j = (k - 1 - i) mod m
        j = jnp.mod(k - 1 - i, m)
        valid = rho[j] != 0.0
        alpha = jnp.where(valid, rho[j] * jnp.dot(s_hist[j], q), 0.0)
        q = q - alpha * y_hist[j]
        return q, alphas.at[j].set(alpha)

    q, alphas = jax.lax.fori_loop(
        0, m, bwd, (q, jnp.zeros(m, dtype=g.dtype) + _vma0(g))
    )

    jlast = jnp.mod(k - 1, m)
    sy = jnp.dot(s_hist[jlast], y_hist[jlast])
    yy = jnp.dot(y_hist[jlast], y_hist[jlast])
    gamma = jnp.where((sy > 0) & (yy > 0), sy / jnp.maximum(yy, 1e-300), 1.0)
    r = gamma * q

    def fwd(i, r):
        # iterate oldest -> newest: j = (k - m + i) mod m
        j = jnp.mod(k - m + i, m)
        valid = rho[j] != 0.0
        beta = jnp.where(valid, rho[j] * jnp.dot(y_hist[j], r), 0.0)
        return r + jnp.where(valid, (alphas[j] - beta), 0.0) * s_hist[j]

    return jax.lax.fori_loop(0, m, fwd, r)


def _build(fun, lo, hi, dim, dtype, m, gtol, ftol, max_linesearch, c1):
    """Shared L-BFGS machinery: returns ``(init, body, proj_grad_norm)``
    closures used by both the one-shot :func:`lbfgs_minimize` and the
    host-chunked :func:`lbfgs_minimize_chunked` drivers."""
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)

    has_box = lo is not None or hi is not None
    lo_arr = jnp.full((dim,), -jnp.inf, dtype) if lo is None else jnp.asarray(lo, dtype)
    hi_arr = jnp.full((dim,), jnp.inf, dtype) if hi is None else jnp.asarray(hi, dtype)

    def project(u):
        return jnp.clip(u, lo_arr, hi_arr) if has_box else u

    vg = jax.value_and_grad(fun)

    def init(u0):
        u0 = project(u0)
        f0, g0 = vg(u0)
        bad_start = ~jnp.isfinite(f0)
        vz = _vma0(f0)
        return _State(
            k=jnp.zeros((), jnp.int32),
            u=u0,
            f=jnp.where(bad_start, big, f0),
            g=jnp.where(jnp.isfinite(g0), g0, 0.0),
            s_hist=jnp.zeros((m, dim), dtype) + vz,
            y_hist=jnp.zeros((m, dim), dtype) + vz,
            rho=jnp.zeros((m,), dtype) + vz,
            done=bad_start,
        )

    def proj_grad_norm(u, g):
        # norm of P(u - g) - u : zero exactly at a constrained stationary point
        return jnp.max(jnp.abs(project(u - g) - u))

    def body(st: _State):
        d = -_two_loop(st.g, st.s_hist, st.y_hist, st.rho, st.k, m)
        # fall back to steepest descent if direction is not a descent direction
        descent = jnp.dot(d, st.g) < 0
        d = jnp.where(descent, d, -st.g)

        def ls_body(carry):
            t, _, _, _, it = carry
            u_new = project(st.u + t * d)
            f_new, _ = vg(u_new)
            du = u_new - st.u
            ok = jnp.isfinite(f_new) & (f_new <= st.f + c1 * jnp.dot(st.g, du))
            return (t * 0.5, u_new, f_new, ok, it + 1)

        def ls_cond(carry):
            _, _, _, ok, it = carry
            return (~ok) & (it < max_linesearch)

        t0 = jnp.ones((), dtype)
        _, u_new, f_new, ls_ok, _ = jax.lax.while_loop(
            ls_cond, ls_body, ls_body((t0, st.u, st.f, st.f != st.f, 0))
        )

        s = u_new - st.u
        _, g_new = vg(u_new)
        y = g_new - st.g
        sy = jnp.dot(s, y)
        slot = jnp.mod(st.k, m)
        do_update = ls_ok & (sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y))
        s_hist = jnp.where(do_update, st.s_hist.at[slot].set(s), st.s_hist)
        y_hist = jnp.where(do_update, st.y_hist.at[slot].set(y), st.y_hist)
        rho = jnp.where(
            do_update, st.rho.at[slot].set(1.0 / jnp.maximum(sy, 1e-300)), st.rho
        )

        g_new = jnp.where(jnp.isfinite(g_new), g_new, st.g)
        converged = proj_grad_norm(u_new, g_new) < gtol
        f_stall = (st.f - f_new) <= ftol * jnp.maximum(
            jnp.maximum(jnp.abs(st.f), jnp.abs(f_new)), 1.0
        )
        done = converged | (~ls_ok) | f_stall

        accept = ls_ok
        return _State(
            k=st.k + 1,
            u=jnp.where(accept, u_new, st.u),
            f=jnp.where(accept, f_new, st.f),
            g=jnp.where(accept, g_new, st.g),
            s_hist=s_hist,
            y_hist=y_hist,
            rho=rho,
            done=done,
        )

    return init, body, proj_grad_norm


def lbfgs_minimize(
    fun: Callable,
    u0: jnp.ndarray,
    lo: jnp.ndarray | None = None,
    hi: jnp.ndarray | None = None,
    max_iter: int = 500,
    history: int = 10,
    gtol: float = 1e-5,
    ftol: float = 2.2e-9,
    max_linesearch: int = 25,
    c1: float = 1e-4,
) -> LBFGSResult:
    """Minimize ``fun(u)`` subject to ``lo <= u <= hi`` (either may be None).

    Pure function of its inputs: safe under ``jit`` and ``vmap``.
    """
    init, body, proj_grad_norm = _build(
        fun, lo, hi, u0.shape[-1], u0.dtype, history, gtol, ftol,
        max_linesearch, c1,
    )
    st0 = init(u0)
    bad_start = st0.done

    def cond(st: _State):
        return (~st.done) & (st.k < max_iter)

    final = jax.lax.while_loop(cond, body, st0)
    converged = proj_grad_norm(final.u, final.g) < gtol
    return LBFGSResult(
        u=final.u,
        f=final.f,
        n_iter=final.k,
        converged=converged,
        failed=bad_start,
    )


def lbfgs_minimize_chunked(
    fun: Callable,
    u0s: jnp.ndarray,
    lo: jnp.ndarray | None = None,
    hi: jnp.ndarray | None = None,
    max_iter: int = 500,
    history: int = 10,
    gtol: float = 1e-5,
    ftol: float = 2.2e-9,
    max_linesearch: int = 25,
    c1: float = 1e-4,
    chunk_iters: int = 4,
    state_path: str | None = None,
    max_wall_seconds: float | None = None,
) -> LBFGSResult:
    """Batched box L-BFGS driven in fixed-size iteration chunks with a host
    sync between chunks.

    Iterates are bit-identical to ``vmap(lbfgs_minimize)`` — the chunk
    boundary only splits the ``while_loop``.  It exists for runs that must
    checkpoint (``state_path``) or stop on a wall-clock budget between
    dispatches.  One compiled chunk program serves the whole run — the
    loop bound ``k_end`` is a traced scalar.

    :param u0s: (n_restarts, dim) batch of starting points.
    :param chunk_iters: iterations per dispatch.  Each iteration costs
        2 + linesearch batched objective evals.
    :param state_path: checkpoint the optimizer state after every chunk
        and resume from it on the next call (crash recovery; same pattern
        as ``nuts_chains_chunked``).  The checkpoint
        is fingerprinted by (u0s, bounds, tolerances) and ignored with a
        warning on mismatch or corruption.
    :param max_wall_seconds: raise :class:`LBFGSTimeBudget` at the first
        chunk boundary past this wall-clock budget (requires
        ``state_path`` so the raise loses no progress).
    :returns: :class:`LBFGSResult` with a leading (n_restarts,) axis.
    """
    import hashlib
    import os
    import time as _time

    import numpy as np

    if max_wall_seconds is not None and not state_path:
        raise ValueError("max_wall_seconds requires state_path")
    t_start = _time.monotonic()

    init, body, proj_grad_norm = _build(
        fun, lo, hi, u0s.shape[-1], u0s.dtype, history, gtol, ftol,
        max_linesearch, c1,
    )

    def run_chunk(st, k_end):
        return jax.lax.while_loop(
            lambda s: (~s.done) & (s.k < k_end), body, st
        )

    step = jax.jit(jax.vmap(run_chunk, in_axes=(0, None)))
    st = jax.jit(jax.vmap(init))(u0s)
    failed = st.done
    k_end = 0

    fp = None
    if state_path:
        from ..io.checkpoint import load_sampler_state, save_sampler_state

        fp = hashlib.sha256(
            repr((
                np.asarray(u0s).tobytes(),
                None if lo is None else np.asarray(lo).tobytes(),
                None if hi is None else np.asarray(hi).tobytes(),
                int(max_iter), int(history), float(gtol), float(ftol),
                int(max_linesearch), float(c1),
            )).encode()
        ).hexdigest()
        if os.path.exists(state_path + ".npz"):
            try:
                saved = load_sampler_state(state_path)
                if str(np.asarray(saved.get("config", ""))) == fp:
                    st = jax.tree_util.tree_map(jnp.asarray, saved["state"])
                    failed = jnp.asarray(saved["failed"])
                    k_end = int(np.asarray(saved["k_end"]))
                else:
                    import warnings

                    warnings.warn(
                        "lbfgs_minimize_chunked: checkpoint at %r is from a "
                        "different run — starting fresh" % state_path
                    )
            except Exception as e:
                import warnings

                warnings.warn(
                    "lbfgs_minimize_chunked: could not resume from %r (%s)"
                    % (state_path, e)
                )

    while k_end < max_iter:
        k_end = min(k_end + chunk_iters, max_iter)
        st = step(st, jnp.asarray(k_end, jnp.int32))
        all_done = bool(np.asarray(jax.device_get(st.done)).all())  # host sync
        if state_path:
            save_sampler_state(
                {
                    "state": jax.device_get(st),
                    "failed": np.asarray(failed),
                    "k_end": k_end,
                    "config": fp,
                },
                state_path,
                backend="npz",
            )
        if all_done:
            break
        if (
            max_wall_seconds is not None
            and _time.monotonic() - t_start > max_wall_seconds
        ):
            raise LBFGSTimeBudget(
                f"L-BFGS paused at iteration {k_end} after "
                f"{_time.monotonic() - t_start:.0f} s; state saved to "
                f"{state_path!r} — rerun the same call to continue"
            )
    converged = jax.jit(jax.vmap(proj_grad_norm))(st.u, st.g) < gtol
    return LBFGSResult(
        u=st.u, f=st.f, n_iter=st.k, converged=converged, failed=failed,
    )
