"""Vectorized iterative NUTS (No-U-Turn Sampler) in pure JAX.

Replaces the reference's multi-restart MAP (its only hyperparameter
inference, ``/root/reference/src/gpcsd/gpcsd1d.py:130-246``) with full
posterior sampling — the north-star capability of BASELINE.json.

Design notes:
- *Iterative* tree building: the recursive NUTS of Hoffman & Gelman (2014)
  is reformulated with O(max_depth) checkpoint buffers so the whole
  transition is two nested ``lax.while_loop``s — compilable, fixed-shape,
  vmappable over chains.  Sub-U-turn checks use the trailing-bits scheme:
  a height-h subtree ending at leaf n (h <= trailing_ones(n)) starts at
  s = n+1-2^h whose checkpoint lives in slot popcount(s); the slots checked
  at leaf n form the contiguous range [popcount(n+1)-1, popcount(n+1)-2+t].
- Multinomial (progressive) sampling within subtrees, biased progressive
  sampling across doublings, generalized U-turn criterion
  ``dot(rho, v_end) <= 0`` with diagonal metric (Betancourt 2017).
- Warmup: dual averaging to ``target_accept`` + Welford diagonal mass
  adaptation on the Stan three-phase window schedule
  (:func:`gpcsd_tpu.infer.hmc.stan_warmup_schedule`).
- Chains are a ``vmap`` axis; the multi-host story shards the chain axis
  over a device mesh (see :mod:`gpcsd_tpu.parallel`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .hmc import (
    as_aux_vga,
    da_init,
    da_update,
    draw_momentum,
    find_reasonable_step_size,
    kinetic,
    leapfrog,
    mass_velocity,
    stan_warmup_schedule,
    welford_init,
    welford_update,
    welford_variance,
)
from .dense_metric import (
    dense_welford_cov,
    dense_welford_init,
    dense_welford_update,
)

MAX_DELTA_ENERGY = 1000.0


def _tree_where(cond, a, b):
    return jax.tree.map(lambda x, y: jnp.where(cond, x, y), a, b)


def _popcount(n):
    def body(i, acc):
        return acc + ((n >> i) & 1)

    return jax.lax.fori_loop(0, 16, body, jnp.zeros_like(n))


def _trailing_ones(n):
    return _popcount(n ^ (n + 1)) - 1


def _is_turning(rho, v_first, v_last):
    return (jnp.dot(rho, v_first) <= 0) | (jnp.dot(rho, v_last) <= 0)


class _SubtreeState(NamedTuple):
    n: jnp.ndarray
    z: jnp.ndarray
    r: jnp.ndarray
    grad: jnp.ndarray
    logp: jnp.ndarray
    rho: jnp.ndarray  # momentum sum within subtree
    z_prop: jnp.ndarray
    logp_prop: jnp.ndarray
    grad_prop: jnp.ndarray
    log_sum_w: jnp.ndarray
    sum_accept: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    aux: object  # solver warm-start state at the moving end (pytree)
    # checkpoint buffers, one slot per tree level
    z_ckpt: jnp.ndarray  # (max_depth, dim)
    v_ckpt: jnp.ndarray
    rho_before_ckpt: jnp.ndarray


def _build_subtree(
    value_and_grad, key, z0, r0, grad0, aux0, direction, num_leaves, energy0,
    step_size, inv_mass, max_depth,
):
    """Take ``num_leaves`` leapfrog steps from (z0, r0), progressively
    sampling a proposal and checking U-turns at every power-of-two boundary.
    """
    dim = z0.shape[-1]
    dtype = z0.dtype
    signed_step = direction * step_size

    vz = jnp.sum(z0) * 0.0  # zero carrying the chain-varying VMA type
    vfalse = vz != 0.0

    init = _SubtreeState(
        n=jnp.zeros((), jnp.int32) + vfalse,
        z=z0,
        r=r0,
        grad=grad0,
        logp=jnp.zeros((), dtype) + vz,
        rho=jnp.zeros_like(r0),
        z_prop=z0,
        logp_prop=jnp.full((), -jnp.inf, dtype) + vz,
        grad_prop=grad0,
        log_sum_w=jnp.full((), -jnp.inf, dtype) + vz,
        sum_accept=jnp.zeros((), dtype) + vz,
        turning=vfalse,
        diverging=vfalse,
        aux=aux0,
        z_ckpt=jnp.zeros((max_depth, dim), dtype) + vz,
        v_ckpt=jnp.zeros((max_depth, dim), dtype) + vz,
        rho_before_ckpt=jnp.zeros((max_depth, dim), dtype) + vz,
    )

    def cond(st: _SubtreeState):
        return (st.n < num_leaves) & ~st.turning & ~st.diverging

    def body(st: _SubtreeState):
        n = st.n
        z, r, logp, grad, aux = leapfrog(
            value_and_grad, st.z, st.r, st.grad, st.aux, signed_step, inv_mass
        )
        energy = -logp + kinetic(r, inv_mass)
        energy = jnp.where(jnp.isfinite(energy), energy, jnp.inf)
        delta = energy - energy0
        diverging = delta > MAX_DELTA_ENERGY
        log_w = -delta

        # progressive multinomial sampling within the subtree
        log_sum_w = jnp.logaddexp(st.log_sum_w, log_w)
        u = jax.random.uniform(jax.random.fold_in(key, n), dtype=dtype)
        take = jnp.log(u) < (log_w - log_sum_w)
        z_prop = jnp.where(take, z, st.z_prop)
        logp_prop = jnp.where(take, logp, st.logp_prop)
        grad_prop = jnp.where(take, grad, st.grad_prop)

        sum_accept = st.sum_accept + jnp.minimum(1.0, jnp.exp(-delta))

        rho_before = st.rho
        rho = st.rho + r
        v = mass_velocity(inv_mass, r)

        # store checkpoint at even leaves: slot = popcount(n)
        slot = _popcount(n)
        is_even = (n % 2) == 0
        z_ckpt = jnp.where(is_even, st.z_ckpt.at[slot].set(z), st.z_ckpt)
        v_ckpt = jnp.where(is_even, st.v_ckpt.at[slot].set(v), st.v_ckpt)
        rho_before_ckpt = jnp.where(
            is_even, st.rho_before_ckpt.at[slot].set(rho_before), st.rho_before_ckpt
        )

        # check all completed power-of-two intervals at odd leaves
        t = _trailing_ones(n)
        idx_min = _popcount(n + 1) - 1
        idx_max = idx_min + t - 1

        def check(i, turning):
            in_range = (i >= idx_min) & (i <= idx_max)
            rho_int = rho - rho_before_ckpt[i]
            turn_i = _is_turning(rho_int, v_ckpt[i], v)
            return turning | (in_range & turn_i)

        turning = jnp.where(
            (n % 2) == 1,
            jax.lax.fori_loop(0, max_depth, check, st.turning),
            st.turning,
        )

        return _SubtreeState(
            n=n + 1, z=z, r=r, grad=grad, logp=logp, rho=rho,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            log_sum_w=log_sum_w, sum_accept=sum_accept,
            turning=turning, diverging=diverging, aux=aux,
            z_ckpt=z_ckpt, v_ckpt=v_ckpt, rho_before_ckpt=rho_before_ckpt,
        )

    return jax.lax.while_loop(cond, body, init)


class NUTSStats(NamedTuple):
    accept_prob: jnp.ndarray
    num_steps: jnp.ndarray
    depth: jnp.ndarray
    diverging: jnp.ndarray
    energy: jnp.ndarray


class _TreeState(NamedTuple):
    depth: jnp.ndarray
    z_fwd: jnp.ndarray
    r_fwd: jnp.ndarray
    grad_fwd: jnp.ndarray
    z_bwd: jnp.ndarray
    r_bwd: jnp.ndarray
    grad_bwd: jnp.ndarray
    z_prop: jnp.ndarray
    logp_prop: jnp.ndarray
    grad_prop: jnp.ndarray
    log_sum_w: jnp.ndarray
    rho: jnp.ndarray
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray
    num_steps: jnp.ndarray
    aux_fwd: object  # warm-start state at the forward trajectory end
    aux_bwd: object


def nuts_transition(
    value_and_grad: Callable, z, logp, grad, key, step_size, inv_mass,
    max_depth: int = 10, aux=(),
):
    """One NUTS update; returns (z', logp', grad', NUTSStats, aux').

    ``value_and_grad`` has the aux-threading signature
    ``(z, aux) -> (logp, grad, aux)`` (:func:`gpcsd_tpu.infer.hmc.as_aux_vga`);
    ``aux`` rides the trajectory ends so iterative solvers inside the
    log-prob warm-start from the previous leapfrog step."""
    dtype = z.dtype
    key_mom, key_dir, key_sub, key_acc = jax.random.split(key, 4)
    r0 = draw_momentum(key_mom, inv_mass, z.shape, dtype)
    energy0 = -logp + kinetic(r0, inv_mass)

    dirs = jax.random.rademacher(key_dir, (max_depth,), jnp.int32).astype(dtype)

    vz = jnp.sum(z) * 0.0
    vfalse = vz != 0.0
    init = _TreeState(
        depth=jnp.zeros((), jnp.int32) + vfalse,
        z_fwd=z, r_fwd=r0, grad_fwd=grad,
        z_bwd=z, r_bwd=r0, grad_bwd=grad,
        z_prop=z, logp_prop=logp, grad_prop=grad,
        log_sum_w=jnp.zeros((), dtype) + vz,
        rho=r0,
        turning=vfalse,
        diverging=vfalse,
        sum_accept=jnp.zeros((), dtype) + vz,
        num_steps=jnp.zeros((), jnp.int32) + vfalse,
        aux_fwd=aux,
        aux_bwd=aux,
    )

    def cond(st: _TreeState):
        return (st.depth < max_depth) & ~st.turning & ~st.diverging

    def body(st: _TreeState):
        direction = dirs[st.depth]
        going_fwd = direction > 0
        z0 = jnp.where(going_fwd, st.z_fwd, st.z_bwd)
        r0_ = jnp.where(going_fwd, st.r_fwd, st.r_bwd)
        g0 = jnp.where(going_fwd, st.grad_fwd, st.grad_bwd)
        aux0 = _tree_where(going_fwd, st.aux_fwd, st.aux_bwd)
        num_leaves = jnp.left_shift(jnp.ones((), jnp.int32), st.depth)

        sub = _build_subtree(
            value_and_grad,
            jax.random.fold_in(key_sub, st.depth),
            z0, r0_, g0, aux0, direction, num_leaves, energy0,
            step_size, inv_mass, max_depth,
        )

        num_steps = st.num_steps + sub.n
        sum_accept = st.sum_accept + sub.sum_accept
        bad = sub.turning | sub.diverging

        # biased progressive sampling across doublings
        u = jax.random.uniform(jax.random.fold_in(key_acc, st.depth), dtype=dtype)
        take = (~bad) & (jnp.log(u) < (sub.log_sum_w - st.log_sum_w))
        z_prop = jnp.where(take, sub.z_prop, st.z_prop)
        logp_prop = jnp.where(take, sub.logp_prop, st.logp_prop)
        grad_prop = jnp.where(take, sub.grad_prop, st.grad_prop)
        log_sum_w = jnp.where(bad, st.log_sum_w, jnp.logaddexp(st.log_sum_w, sub.log_sum_w))

        # extend the trajectory ends and re-check the full-tree U-turn
        z_fwd = jnp.where(going_fwd & ~bad, sub.z, st.z_fwd)
        r_fwd = jnp.where(going_fwd & ~bad, sub.r, st.r_fwd)
        grad_fwd = jnp.where(going_fwd & ~bad, sub.grad, st.grad_fwd)
        z_bwd = jnp.where(~going_fwd & ~bad, sub.z, st.z_bwd)
        r_bwd = jnp.where(~going_fwd & ~bad, sub.r, st.r_bwd)
        grad_bwd = jnp.where(~going_fwd & ~bad, sub.grad, st.grad_bwd)
        # the subtree-end aux is a valid warm start even for rejected
        # subtrees (any basis is exact); keep it only on accepted extension
        # so the carried state always matches the trajectory end
        aux_fwd = _tree_where(going_fwd & ~bad, sub.aux, st.aux_fwd)
        aux_bwd = _tree_where(~going_fwd & ~bad, sub.aux, st.aux_bwd)
        rho = jnp.where(bad, st.rho, st.rho + sub.rho)
        turning_full = _is_turning(rho, mass_velocity(inv_mass, r_bwd), mass_velocity(inv_mass, r_fwd))

        return _TreeState(
            depth=st.depth + 1,
            z_fwd=z_fwd, r_fwd=r_fwd, grad_fwd=grad_fwd,
            z_bwd=z_bwd, r_bwd=r_bwd, grad_bwd=grad_bwd,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            log_sum_w=log_sum_w, rho=rho,
            turning=st.turning | bad | (~bad & turning_full),
            diverging=st.diverging | sub.diverging,
            sum_accept=sum_accept,
            num_steps=num_steps,
            aux_fwd=aux_fwd, aux_bwd=aux_bwd,
        )

    final = jax.lax.while_loop(cond, body, init)
    accept_prob = final.sum_accept / jnp.maximum(final.num_steps, 1).astype(dtype)
    stats = NUTSStats(
        accept_prob=accept_prob,
        num_steps=final.num_steps,
        depth=final.depth,
        diverging=final.diverging,
        energy=-final.logp_prop,
    )
    return final.z_prop, final.logp_prop, final.grad_prop, stats, final.aux_fwd


class NUTSResult(NamedTuple):
    samples: jnp.ndarray  # (num_samples, dim) — or with leading chain axis
    logp: jnp.ndarray
    accept_prob: jnp.ndarray
    num_steps: jnp.ndarray
    diverging: jnp.ndarray
    step_size: jnp.ndarray
    inv_mass: jnp.ndarray


def _make_vga(log_prob, log_prob_aux, aux0):
    """Build the aux-threading value-and-grad and its initial aux.

    ``log_prob_aux``, when given, is ``(u, aux) -> (logp, aux_new)`` —
    e.g. ``ModelFns.log_prob_basis`` closed over Y — and takes precedence
    over the plain ``log_prob`` inside the sampler hot loop."""
    if log_prob_aux is None:
        return as_aux_vga(jax.value_and_grad(log_prob)), ()
    vg = jax.value_and_grad(log_prob_aux, has_aux=True)

    def vga(z, aux):
        (logp, aux_new), grad = vg(z, aux)
        return logp, grad, aux_new

    return vga, aux0


def nuts_run(
    log_prob: Callable,
    u0,
    key,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 1.0,
    adapt_mass: bool = True,
    dense_mass: bool = False,
    log_prob_aux: Callable | None = None,
    aux0=None,
) -> NUTSResult:
    """Single-chain NUTS with Stan-style warmup.  ``vmap`` for chains.

    :param dense_mass: adapt a FULL-covariance metric (Stan dense_e
        analog) instead of the diagonal one — the round-4 paper-run
        diagnosis's first geometry lever (a dense 30-dim posterior ridge
        that a diagonal metric cannot represent; PERF.md round 4).
        ``inv_mass`` is then a (dim, dim) posterior-covariance estimate;
        leapfrog/kinetic/momentum dispatch on its rank at trace time.

    :param log_prob: ``u -> scalar`` unnormalized posterior log-density.
    :param log_prob_aux: optional ``(u, aux) -> (logp, aux_new)`` variant
        threading solver warm-start state (e.g. the temporal eigenbasis,
        ``ModelFns.log_prob_basis``) along the trajectory; used for every
        leapfrog when given.  ``log_prob`` is still required for API
        uniformity but only its aux variant is evaluated in the hot loop.
    :param aux0: initial aux (required with ``log_prob_aux``).
    """
    value_and_grad, aux_init = _make_vga(log_prob, log_prob_aux, aux0)
    dim = u0.shape[-1]
    dtype = u0.dtype

    key_init, key_warm, key_samp = jax.random.split(key, 3)
    inv_mass0 = (
        jnp.eye(dim, dtype=dtype) if dense_mass else jnp.ones((dim,), dtype)
    )
    step0 = find_reasonable_step_size(
        value_and_grad, u0, key_init, inv_mass0, init=init_step_size,
        aux=aux_init,
    )

    slow_mask_np, window_end_np = stan_warmup_schedule(num_warmup)
    total = num_warmup + num_samples
    # single fused scan over warmup + sampling: the transition is traced
    # once instead of twice, halving compile time
    slow_mask = jnp.zeros(total, bool).at[:num_warmup].set(jnp.asarray(slow_mask_np))
    window_end = jnp.zeros(total, bool).at[:num_warmup].set(jnp.asarray(window_end_np))
    is_warmup = jnp.arange(total) < num_warmup

    logp0, grad0, aux0_ = value_and_grad(u0, aux_init)

    def step(carry, inputs):
        i, k = inputs
        z, logp, grad, da, wf, inv_mass, aux = carry
        step_size = jnp.where(
            is_warmup[i], jnp.exp(da.log_step), jnp.exp(da.log_step_avg)
        )
        z, logp, grad, stats, aux = nuts_transition(
            value_and_grad, z, logp, grad, k, step_size, inv_mass,
            max_depth=max_depth, aux=aux,
        )
        da = jax.lax.cond(
            is_warmup[i],
            lambda: da_update(da, stats.accept_prob, target=target_accept),
            lambda: da,
        )
        wf = jax.lax.cond(
            slow_mask[i] & adapt_mass, lambda: _wf_update(wf, z), lambda: wf
        )

        def refresh():
            new_inv_mass = _wf_estimate(wf)
            new_da = da_init(jnp.exp(da.log_step_avg))
            fresh = _wf_init()
            fresh = fresh._replace(mean=fresh.mean + vz, m2=fresh.m2 + vz)
            return fresh, new_inv_mass, new_da

        wf, inv_mass, da = jax.lax.cond(
            window_end[i] & adapt_mass,
            refresh,
            lambda: (wf, inv_mass, da),
        )
        return (z, logp, grad, da, wf, inv_mass, aux), (z, logp, stats)

    if dense_mass:
        _wf_init = lambda: dense_welford_init(dim, dtype)
        _wf_update = dense_welford_update
        _wf_estimate = dense_welford_cov
    else:
        _wf_init = lambda: welford_init(dim, dtype)
        _wf_update = welford_update
        _wf_estimate = welford_variance
    vz = jnp.sum(u0) * 0.0  # VMA seed for constant-initialized carries
    wf0 = _wf_init()
    wf0 = wf0._replace(mean=wf0.mean + vz, m2=wf0.m2 + vz)
    keys = jax.random.split(key_warm, total)
    del key_samp  # the fused scan consumes a single key stream
    carry = (u0, logp0, grad0, da_init(step0), wf0, inv_mass0 + vz, aux0_)
    carry, (samples, logps, stats) = jax.lax.scan(
        step, carry, (jnp.arange(total), keys)
    )
    _, _, _, da, _, inv_mass, _ = carry
    step_size = jnp.exp(da.log_step_avg)
    return NUTSResult(
        samples=samples[num_warmup:],
        logp=logps[num_warmup:],
        accept_prob=stats.accept_prob[num_warmup:],
        num_steps=stats.num_steps[num_warmup:],
        diverging=stats.diverging[num_warmup:],
        step_size=step_size,
        inv_mass=inv_mass,
    )


def nuts_chains(log_prob, u0s, key, num_chains=None, **kw) -> NUTSResult:
    """Run vmapped chains; ``u0s`` is (nchains, dim)."""
    nchains = u0s.shape[0]
    keys = jax.random.split(key, nchains)
    return jax.vmap(lambda u0, k: nuts_run(log_prob, u0, k, **kw))(u0s, keys)


def _pool_welford_chains(wf):
    """Combine per-chain Welford states into one pooled estimate, broadcast
    back to every chain (parallel-Welford merge; ``m2`` is divided by the
    chain count so per-chain counts keep their scale and the implied
    variance equals the pooled variance).  Chains have equal counts.
    Handles both the diagonal state ((chains, dim) ``m2``) and the dense
    one ((chains, dim, dim) — cross terms pooled with outer products)."""
    mean, m2, cnt = wf.mean, wf.m2, wf.count
    nchains = mean.shape[0]
    mean_tot = jnp.mean(mean, axis=0)
    d = mean - mean_tot[None]
    w = cnt.astype(mean.dtype)
    if m2.ndim == 3:  # dense
        between = jnp.einsum("c,ci,cj->ij", w, d, d)
    else:
        between = jnp.sum(jnp.square(d) * w[:, None], axis=0)
    m2_each = (jnp.sum(m2, axis=0) + between) / nchains
    return type(wf)(
        mean=jnp.broadcast_to(mean_tot, mean.shape),
        m2=jnp.broadcast_to(m2_each, m2.shape),
        count=cnt,
    )


def stepsize_floor_guard(carry, nchains, chunk=-1, floor=1e-6):
    """Replace collapsed-step chains with the healthiest chain's full state.

    A chain whose dual-averaged step size sits orders of magnitude below
    the others is trapped (whitening mismatch / f32-hostile start), and
    dual averaging is in equilibrium AT that step — it never recovers on
    its own, it just burns the run's budget (the 2D probe lost two of
    four chains to steps ~1e-9; the round-3 rescue lost one to 0.0
    acceptance for 75 transitions — VERDICT r4 weak #5).  The fix is a
    restart from a healthy chain's complete state (position, logp/grad,
    dual-averaging, Welford, metric, basis aux) — valid because warmup
    draws carry no posterior-correctness obligation.

    Host-side, between dispatches: every carry leaf is chain-vmapped
    (leading axis == nchains), so the surgery is a row copy; the compiled
    chunk program is untouched and a healthy run never triggers it.
    Returns the (possibly repaired) carry.
    """
    da = carry[3]
    steps = np.exp(np.asarray(jax.device_get(da.log_step_avg)))
    # reference = median of the plausibly-healthy chains (within 1e3x of
    # the best), so a MAJORITY of collapsed chains cannot drag the median
    # down to their own scale and mask themselves
    healthy = steps[steps >= 1e-3 * steps.max()]
    med = float(np.median(healthy))
    sick = np.where(steps < floor * med)[0]
    if sick.size == 0 or sick.size >= nchains:
        return carry
    donor = int(np.argmax(steps))
    import warnings

    warnings.warn(
        "nuts_chains_chunked: step-size floor guard at chunk %d — "
        "chain(s) %s collapsed to %s (healthy median %.3g); "
        "reinitializing from chain %d (step %.3g)"
        % (chunk, sick.tolist(), steps[sick].tolist(), med, donor,
           float(steps[donor]))
    )
    host = jax.device_get(carry)

    def rep(x):
        x = np.array(x)
        if x.ndim >= 1 and x.shape[0] == nchains:
            x[sick] = x[donor]
        return x

    return jax.tree_util.tree_map(rep, host)


def nuts_chains_chunked(
    log_prob: Callable,
    u0s,
    key,
    num_warmup: int = 500,
    num_samples: int = 500,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_step_size: float = 1.0,
    adapt_mass: bool = True,
    chunk_size: int = 10,
    callback=None,
    pool_warmup: bool = False,
    state_path: str | None = None,
    save_every: int = 1,
    dense_mass: bool = False,
    log_prob_aux: Callable | None = None,
    aux0=None,
    stepsize_guard: bool = True,
) -> NUTSResult:
    """Chunked multi-chain NUTS: the adaptation/sampling loop runs as a host
    loop over fixed-size jitted scan chunks (warmup masks are *inputs*, so
    one compiled chunk program serves the whole run).

    Chunking keeps the compiled program small, enables progress
    reporting/checkpointing between chunks (``callback(i, state)``), and
    costs one host sync per ``chunk_size`` transitions.

    Returns the same :class:`NUTSResult` layout as :func:`nuts_chains`.

    :param pool_warmup: share the Welford mass-matrix statistics across all
        chains at every chunk boundary during warmup (parallel-chain
        adaptation) — each chain's metric is then estimated from
        nchains-times more draws.  Step-size adaptation stays per-chain.
    :param state_path: checkpoint the full driver state (carry + collected
        outputs) to this path after every chunk, and RESUME from it if it
        already exists: after a crash, rerunning the same call continues
        from the last completed chunk instead of restarting.
    :param stepsize_guard: at 25%/50%/75% of warmup, reinitialize any
        chain whose dual-averaged step size has collapsed below 1e-6x the
        cross-chain median from the healthiest chain's full state
        (position, gradients, adaptation, basis aux).  A collapsed step
        is the signature of a chain trapped by the whitening mismatch or
        an f32-hostile start (the 2D probe burned half its budget on two
        chains pinned at ~1e-9 while the others sampled — VERDICT r4 weak
        #5); the donor copy is a valid re-start that preserves warmup
        progress.  Host-side surgery at a chunk boundary: the compiled
        chunk program is unchanged, and a healthy run never triggers it.
    """
    import os as _os

    from ..io.checkpoint import load_sampler_state, save_sampler_state
    value_and_grad, aux_init = _make_vga(log_prob, log_prob_aux, aux0)
    nchains, dim = u0s.shape
    dtype = u0s.dtype
    # metric representation (see nuts_run dense_mass): dispatch is static
    if dense_mass:
        _wf_init = lambda: dense_welford_init(dim, dtype)
        _wf_update = dense_welford_update
        _wf_estimate = dense_welford_cov
        _im0 = lambda: jnp.eye(dim, dtype=dtype)
    else:
        _wf_init = lambda: welford_init(dim, dtype)
        _wf_update = welford_update
        _wf_estimate = welford_variance
        _im0 = lambda: jnp.ones((dim,), dtype)

    slow_np, wend_np = stan_warmup_schedule(num_warmup)
    total = num_warmup + num_samples
    pad = (-total) % chunk_size
    slow = np.zeros(total + pad, bool)
    wend = np.zeros(total + pad, bool)
    warm = np.zeros(total + pad, bool)
    slow[:num_warmup] = slow_np
    wend[:num_warmup] = wend_np
    warm[:num_warmup] = True
    active = np.arange(total + pad) < total  # padded steps are no-ops

    def chunk(carry, masks, keys):
        def step(carry, inputs):
            is_w, is_slow, is_end, is_active, k = inputs
            z, logp, grad, da, wf, inv_mass, aux = carry
            step_size = jnp.where(
                is_w, jnp.exp(da.log_step), jnp.exp(da.log_step_avg)
            )
            z2, logp2, grad2, stats, aux2 = nuts_transition(
                value_and_grad, z, logp, grad, k, step_size, inv_mass,
                max_depth=max_depth, aux=aux,
            )
            z = jnp.where(is_active, z2, z)
            logp = jnp.where(is_active, logp2, logp)
            grad = jnp.where(is_active, grad2, grad)
            aux = _tree_where(is_active, aux2, aux)
            da = jax.lax.cond(
                is_w & is_active,
                lambda: da_update(da, stats.accept_prob, target=target_accept),
                lambda: da,
            )
            wf = jax.lax.cond(
                is_slow & adapt_mass, lambda: _wf_update(wf, z), lambda: wf
            )

            def refresh():
                new_inv_mass = _wf_estimate(wf)
                new_da = da_init(jnp.exp(da.log_step_avg))
                return _wf_init(), new_inv_mass, new_da

            wf, inv_mass, da = jax.lax.cond(
                is_end & adapt_mass, refresh, lambda: (wf, inv_mass, da)
            )
            return (z, logp, grad, da, wf, inv_mass, aux), (z, logp, stats)

        return jax.lax.scan(step, carry, (*masks, keys))

    chunk_chains = jax.jit(jax.vmap(chunk, in_axes=(0, None, 0)))

    key_init, key_run = jax.random.split(key)

    def _fresh_carry():
        """Initial driver carry (step-size search + first evaluations).

        Deferred behind the checkpoint-resume check: on a resume the
        checkpointed carry replaces all of this, and tracing + running the
        step-size search (a full NUTS-sized program) is wasted work.
        """
        inv_mass0 = _im0()
        step0 = jax.vmap(
            lambda u0, k: find_reasonable_step_size(
                value_and_grad, u0, k, inv_mass0, init=init_step_size,
                aux=aux_init,
            )
        )(u0s, jax.random.split(key_init, nchains))
        logp0, grad0, aux0_ = jax.vmap(lambda u: value_and_grad(u, aux_init))(u0s)
        return (
            u0s, logp0, grad0,
            jax.vmap(da_init)(step0),
            jax.vmap(lambda _: _wf_init())(jnp.arange(nchains)),
            jnp.tile(inv_mass0[None], (nchains,) + (1,) * inv_mass0.ndim),
            aux0_,
        )

    n_chunks = (total + pad) // chunk_size
    keys = jax.random.split(key_run, nchains * (total + pad)).reshape(
        nchains, total + pad, 2
    )
    # Fingerprint the run configuration so resume never silently continues
    # a *different* run (changed seed/lengths/chunking) or returns a
    # finished checkpoint's samples for a new configuration.
    import hashlib as _hashlib

    config_fp = _hashlib.sha256(
        repr(
            (
                np.asarray(key).tobytes(),
                np.asarray(u0s).tobytes(),  # changed inits = different run
                int(nchains), int(dim), int(num_warmup), int(num_samples),
                int(chunk_size), int(max_depth), float(target_accept),
                bool(adapt_mass), bool(pool_warmup), bool(dense_mass),
            )
        ).encode()
    ).hexdigest()

    # AOT program cache: serialize the traced+lowered chunk program next
    # to the checkpoint so resume attempts skip re-tracing — the
    # per-attempt ~420 s first-chunk tax on the paper run is Python
    # tracing/lowering, which the XLA persistent compile cache cannot
    # help (PERF.md round-4 'compile tax').  Keyed on the run config
    # fingerprint + a hash of the package source + jax version + backend;
    # any failure falls back to the plain jit path.
    chunk_call = chunk_chains
    if state_path:
        import hashlib as _hl
        import glob as _glob

        # the carry/output pytrees contain NamedTuples, which jax.export
        # refuses to serialize unless registered with stable names
        from .hmc import DualAveragingState, WelfordState
        from .dense_metric import DenseWelfordState

        for _nt_cls in (DualAveragingState, WelfordState, DenseWelfordState,
                        NUTSStats):
            try:
                jax.export.register_namedtuple_serialization(
                    _nt_cls,
                    serialized_name="gpcsd_tpu.infer." + _nt_cls.__name__,
                )
            except ValueError:
                pass  # already registered in this process

        pkg_dir = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
        h = _hl.sha256()
        for p in sorted(_glob.glob(_os.path.join(pkg_dir, "**", "*.py"),
                                   recursive=True)):
            with open(p, "rb") as f:
                h.update(f.read())
        code_fp = "%s:%s:%s:%s" % (
            h.hexdigest(), jax.__version__, jax.default_backend(), config_fp
        )
        aot_path = state_path + ".chunk_aot.bin"
        _aot_fn = None
        if _os.path.exists(aot_path):
            try:
                with open(aot_path, "rb") as f:
                    hdr = f.readline().strip().decode()
                    data = f.read()
                if hdr == code_fp:
                    _aot_fn = jax.export.deserialize(data).call
            except Exception:
                _aot_fn = None
        if _aot_fn is not None:
            chunk_call = _aot_fn
        else:
            _box = {}

            def chunk_call(carry, masks, keys):
                if "fn" not in _box:
                    try:
                        exp = jax.export.export(chunk_chains)(carry, masks, keys)
                        tmp = aot_path + ".tmp"
                        with open(tmp, "wb") as f:
                            f.write((code_fp + "\n").encode())
                            f.write(exp.serialize())
                        _os.replace(tmp, aot_path)
                        _box["fn"] = exp.call
                    except Exception as e:
                        import warnings

                        warnings.warn(
                            "nuts_chains_chunked: AOT export failed (%s: %s)"
                            " — falling back to jit (the failed export "
                            "already paid a trace; fix the cause to stop "
                            "paying it twice)" % (type(e).__name__, e)
                        )
                        _box["fn"] = chunk_chains
                return _box["fn"](carry, masks, keys)

    # per-chunk output files: each completed chunk's (z, logp, stats) is
    # written ONCE to its own .out<c>.npz — re-serializing the whole
    # history every chunk is O(n_chunks^2) I/O and was measured costing
    # ~27 s/chunk by chunk 300 of the paper run
    import pickle as _pickle

    def _save_out_chunk(c, out):
        flat, treedef = jax.tree_util.tree_flatten(out)
        tdp = state_path + ".out_treedef.pkl"
        if not _os.path.exists(tdp):
            with open(tdp + ".tmp", "wb") as f:
                _pickle.dump(treedef, f)
            _os.replace(tdp + ".tmp", tdp)
        tmp = state_path + ".out%05d.npz.tmp" % c
        with open(tmp, "wb") as f:
            np.savez(f, **{str(i): np.asarray(l) for i, l in enumerate(flat)})
        _os.replace(tmp, state_path + ".out%05d.npz" % c)

    def _load_out_chunks(n):
        with open(state_path + ".out_treedef.pkl", "rb") as f:
            treedef = _pickle.load(f)
        loaded = []
        for c in range(n):
            data = np.load(state_path + ".out%05d.npz" % c)
            loaded.append(jax.tree_util.tree_unflatten(
                treedef, [data[str(i)] for i in range(len(data.files))]
            ))
        return loaded

    outs = []
    start_chunk = 0
    carry = None
    if state_path and _os.path.exists(state_path + ".npz"):
        try:
            st = load_sampler_state(state_path)
            saved_fp = str(np.asarray(st.get("config", "")))
            if saved_fp != config_fp:
                import warnings

                warnings.warn(
                    "nuts_chains_chunked: checkpoint at %r was written by a "
                    "different run configuration — starting fresh" % state_path
                )
            else:
                start_chunk = int(np.asarray(st["next_chunk"]))
                carry = tuple(st["carry"])
                if _os.path.exists(state_path + ".out%05d.npz" % max(start_chunk - 1, 0)):
                    outs = _load_out_chunks(start_chunk)
                else:
                    # legacy single-file checkpoint: convert to per-chunk
                    outs = list(st["outs"])
                    for c0, o in enumerate(outs):
                        _save_out_chunk(c0, o)
        except Exception as e:  # truncated/corrupt checkpoint: fresh start
            import warnings

            warnings.warn(
                "nuts_chains_chunked: could not resume from %r (%s) — "
                "starting fresh" % (state_path, e)
            )
            outs = []
            start_chunk = 0
            carry = None
    if carry is None:
        carry = _fresh_carry()
    last_saved = start_chunk - 1

    # step-size floor guard check chunks: the first chunk boundary at or
    # past each warmup fraction (only meaningful with >= 2 chains)
    guard_chunks = set()
    if stepsize_guard and nchains >= 2 and num_warmup > 0:
        for frac in (0.25, 0.5, 0.75):
            guard_chunks.add(
                int(np.ceil(frac * num_warmup / chunk_size)) - 1
            )

    for c in range(start_chunk, n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        masks = (
            jnp.asarray(warm[sl]), jnp.asarray(slow[sl]),
            jnp.asarray(wend[sl]), jnp.asarray(active[sl]),
        )
        carry, out = chunk_call(carry, masks, keys[:, sl])
        if pool_warmup and adapt_mass and c * chunk_size < num_warmup:
            z, logp, grad, da, wf, inv_mass, aux = carry
            carry = (z, logp, grad, da, _pool_welford_chains(wf), inv_mass, aux)
        if c in guard_chunks:
            carry = stepsize_floor_guard(carry, nchains, chunk=c)
        out = jax.device_get(out)
        outs.append(out)
        if state_path and ((c + 1) % save_every == 0 or c == n_chunks - 1):
            # checkpoint cadence: the carry includes the warm-basis
            # eigenvectors (MBs per chain) — fetching + writing it every
            # chunk can cost more than the chunk's compute, so save_every
            # amortizes it (a crash loses at most
            # save_every-1 chunks)
            for c0 in range(last_saved + 1, c + 1):
                _save_out_chunk(c0, outs[c0])
            # npz backend: the driver state carries NamedTuples (Welford,
            # dual-averaging) whose structure must survive without a
            # template — orbax would restore plain dicts.  The rolling
            # state is O(1): outs live in their own per-chunk files.
            save_sampler_state(
                {
                    "next_chunk": c + 1,
                    "carry": jax.device_get(carry),
                    "config": config_fp,
                },
                state_path,
                backend="npz",
            )
            last_saved = c
        if callback is not None:
            callback(c, carry)

    zs = np.concatenate([o[0] for o in outs], axis=1)[:, :total]
    lps = np.concatenate([o[1] for o in outs], axis=1)[:, :total]
    stats = [o[2] for o in outs]
    cat = lambda f: np.concatenate([np.asarray(f(s)) for s in stats], axis=1)[:, :total]
    _, _, _, da, _, inv_mass, _ = carry
    return NUTSResult(
        samples=zs[:, num_warmup:],
        logp=lps[:, num_warmup:],
        accept_prob=cat(lambda s: s.accept_prob)[:, num_warmup:],
        num_steps=cat(lambda s: s.num_steps)[:, num_warmup:],
        diverging=cat(lambda s: s.diverging)[:, num_warmup:],
        step_size=np.exp(np.asarray(da.log_step_avg)),
        inv_mass=np.asarray(inv_mass),
    )
