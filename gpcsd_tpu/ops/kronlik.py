"""Kronecker-structured Gaussian marginal likelihood and solves.

The whole framework's performance story (reference SURVEY.md §1) hangs on the
identity: for ``K = Ks (x) Kt + diag(sig2n)`` with ``Ks = Qs Ls Qs^T`` and
``Kt = Qt Lt Qt^T``,

    K = (Qs (x) Qt) diag(D) (Qs (x) Qt)^T,   D = Ls (x) Lt + sig2n

so the log-likelihood needs only two small ``eigh`` calls plus per-trial
congruence transforms ``Qs^T Y Qt`` (reference ``comp_eig_D``
``/root/reference/src/gpcsd/utility_functions.py:44-64`` and
``GPCSD1D.loglik`` ``gpcsd1d.py:113-128``).

Design decisions:
- trials are a leading batch axis contracted with two batched matmuls
  (``einsum``) instead of the reference's per-trial Python loop;
- the posterior solve is kept *factored* — ``K^{-1} y`` is three small
  matmuls per trial, never the dense ``(nx*nt)^2`` matrix the reference
  materializes in ``GPCSD1D.predict`` (``gpcsd1d.py:262-265``);
- ``eigh`` gets a gap-regularized JVP so hyperparameter gradients stay finite
  when the temporal kernel has (numerically) repeated eigenvalues — the
  downstream likelihood is invariant to rotations inside degenerate
  eigenspaces, so the regularization does not bias its gradient.

Heteroscedastic note: with per-channel sig2n the diagonalization is the same
*approximation* the reference makes (``utility_functions.py:54-63``) — D uses
the eigenbasis of Ks alone.  We reproduce it for parity (SURVEY.md §5).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# gradient-safe symmetric eigendecomposition
# ---------------------------------------------------------------------------

_EIGH_GAP_EPS = 1e-12


@jax.custom_jvp
def eigh_safe(a):
    """Symmetric eigendecomposition with a gap-regularized derivative.

    Returns (eigenvalues, eigenvectors) like ``jnp.linalg.eigh`` (LAPACK on
    the CPU, cuSOLVER on the GPU).
    """
    return jnp.linalg.eigh(a)


@eigh_safe.defjvp
def _eigh_safe_jvp(primals, tangents):
    (a,) = primals
    (da,) = tangents
    w, v = eigh_safe(a)
    hp = jax.lax.Precision.HIGHEST  # float32 inputs: no TF32 on the GPU
    da_sym = 0.5 * (da + jnp.swapaxes(da, -1, -2))
    vt_da_v = jnp.matmul(
        jnp.matmul(jnp.swapaxes(v, -1, -2), da_sym, precision=hp), v, precision=hp
    )
    dw = jnp.diagonal(vt_da_v, axis1=-2, axis2=-1)
    gap = w[..., None, :] - w[..., :, None]  # gap[i, j] = w_j - w_i
    # Lorentzian-regularized inverse gap: behaves like 1/gap for separated
    # eigenvalues, ->0 (instead of inf) inside degenerate clusters.
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=-1, keepdims=True)[..., None], 1.0)
    eps = _EIGH_GAP_EPS * scale
    f = gap / (gap * gap + eps * eps)
    f = f * (1.0 - jnp.eye(w.shape[-1], dtype=a.dtype))
    dv = jnp.matmul(v, f * vt_da_v, precision=hp)
    return (w, v), (dw, dv)


# ---------------------------------------------------------------------------
# mixed-precision eigendecomposition (float32 factor policy)
# ---------------------------------------------------------------------------
#
# Why this exists: NUTS acceptance needs the Hamiltonian resolved to O(1)
# log-units, but the pure-f32 factor policy carries ~2-3 RMS (max ~10)
# log-units of *evaluation noise* at the auditory problem size — measured
# with scripts/f32_noise_probe.py against a CPU float64 control (9e-5 RMS).
# Both paper-scale NUTS attempts collapsed their step size to ~1e-10 on
# exactly this noise.  Decomposition experiments (PERF.md "f32 likelihood
# noise") localize ALL of it in the factor path: (a) rounding the covariance
# itself to f32 costs ~1.5 RMS, (b) the f32 eigendecomposition the rest;
# the f32 whiten/contraction stage is harmless (0.0025 RMS when factors are
# f64-accurate, even with eigenvectors *stored* in f32).
#
# The fix is double-f32 arithmetic: the product of two f32 numbers is exact
# in f64, so an f32 x f32 matmul accumulated in f64 is error-free up to the
# accumulation, and splitting an f64 matrix into an (hi, lo) f32 pair makes
# ``A @ v`` accurate to ~1e-14 relative.  ``eigh_mixed`` runs the fast f32 Jacobi for the
# eigenbasis, then 1-2 double-f32 Rayleigh + first-order rotation
# corrections: eigenvalues come out f64-quality (diag of the exact-product
# Gram), eigenvectors f32-stored but directionally accurate wherever the
# spectral gap is resolvable — which is exactly where directional error
# would otherwise be amplified by the D-ratio in the quadratic form.


def _split_f32(a64):
    """Split a float64 array into an (hi, lo) float32 pair with
    ``hi + lo == a64`` to ~2x f32 mantissa (double-f32 representation)."""
    hi = a64.astype(jnp.float32)
    lo = (a64 - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def _mm_f64acc(a32, b32):
    """f32 x f32 matmul with exact products accumulated in float64.

    The operands are widened first: f32 x f32 products are exact in f64, and
    the GPU backend refuses a mixed f32-operand / f64-result GEMM."""
    return jnp.matmul(a32.astype(jnp.float64), b32.astype(jnp.float64))


def _df32_apply(a_hi, a_lo, v32):
    """``A @ v`` to double-f32 accuracy (A given as an f32 pair); f64 out."""
    return _mm_f64acc(a_hi, v32) + _mm_f64acc(a_lo, v32)


def _df32_gram(v32, m64):
    """``v^T @ M`` with the f64 operand split back into an f32 pair."""
    hi, lo = _split_f32(m64)
    vt = jnp.swapaxes(v32, -1, -2)
    return _mm_f64acc(vt, hi) + _mm_f64acc(vt, lo)


#: Refinement schedule repetitions in :func:`eigh_mixed`.  One repetition =
#: three parallel-order sweeps (even-adjacent, odd-adjacent, mutual-max
#: pairing).  The adjacent sweeps resolve the quasi-degenerate spectral-
#: neighbor pairs of near-Toeplitz kernels (the dominant residual after an
#: f32 eigh); the mutual-max sweep catches non-adjacent stragglers.
EIGH_MIXED_REPS = 2


def _brickwall_masks(n: int):
    """Static brick-wall pairings over sort positions: the f32 eigh returns
    eigenvalues ascending, so spectral neighbors are index neighbors."""
    i_ = np.arange(n)
    m_even = np.zeros((n, n), bool)
    m_even[i_[: n - 1 : 2], i_[1::2]] = True
    m_even |= m_even.T
    m_odd = np.zeros((n, n), bool)
    if n > 2:
        m_odd[i_[1 : n - 1 : 2], i_[2::2]] = True
        m_odd |= m_odd.T
    return jnp.asarray(m_even), jnp.asarray(m_odd)


#: Build the 2x2 rotation angles of each refinement sweep in float32
#: instead of float64.  The angles only ever materialize as the f32
#: rotation matrix ``w_rot`` (the basis ``v`` is f32-stored, so rotations
#: below f32 resolution cannot be represented anyway), while the
#: congruence tracking that carries eigenvalue accuracy stays double-f32.
#: The one cancellation-sensitive quantity (the eigenvalue gap) is still
#: differenced in f64 before the cast.
EIGH_MIXED_F32_ROTATIONS = False


def _rotation_from(b, pairing, f32_rotations: bool):
    """Disjoint-pair 2x2 Jacobi rotation matrix (f32) for one sweep of
    the congruence refinement.  ``pairing`` is a static (n, n) bool mask,
    or None for dynamic mutual-max matching."""
    n = b.shape[-1]
    if f32_rotations:
        wdt = jnp.float32
        d64 = jnp.diagonal(b, axis1=-2, axis2=-1)
        d = d64.astype(wdt)
        # the gap is the difference of near-equal f64 diagonals: difference
        # FIRST (exact in f64), cast after — an f32 difference would lose
        # the quasi-degenerate pairs to cancellation
        gap = (d64[..., None, :] - d64[..., :, None]).astype(wdt)
        c = b.astype(wdt) - d[..., None, :] * jnp.eye(n, dtype=wdt)
    else:
        wdt = jnp.float64
        d = jnp.diagonal(b, axis1=-2, axis2=-1)
        gap = d[..., None, :] - d[..., :, None]
        c = b - d[..., None, :] * jnp.eye(n, dtype=wdt)
    eps64 = float(np.finfo(np.float64).eps)
    absd = jnp.abs(d)
    small = jnp.abs(c) <= eps64 * (
        absd[..., :, None] + absd[..., None, :] + eps64
    )
    # exact 2x2 Jacobi tangents (bounded at 45 degrees inside clusters)
    tau = gap / (2.0 * jnp.where(small, jnp.asarray(1.0, wdt), c))
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, jnp.asarray(1.0, wdt), t)
    t = jnp.where(small, jnp.asarray(0.0, wdt), t)
    if pairing is None:
        # mutual-max matching: each row paired with its strongest
        # coupling when the preference is mutual (disjoint by design)
        score = jnp.abs(c)
        idx = jnp.argmax(score, axis=-1)
        m1 = jax.nn.one_hot(idx, n, dtype=bool) & (score > 0.0)
        pairing = m1 & jnp.swapaxes(m1, -1, -2)
    # disjoint 2x2 rotations compose into an EXACTLY orthogonal W (no
    # damping, no Newton-Schulz): every matched pair is annihilated
    # outright, including quasi-degenerate 45-degree pairs that a
    # damped all-pairs tangent update could never finish off
    c_rot = 1.0 / jnp.sqrt(1.0 + t * t)
    s_rot = t * c_rot
    zero = jnp.asarray(0.0, wdt)
    c_row = jnp.sum(jnp.where(pairing, c_rot - 1.0, zero), axis=-1) + 1.0
    w_rot = (
        c_row[..., :, None] * jnp.eye(n, dtype=wdt)
        + jnp.where(pairing, s_rot, zero)
    ).astype(jnp.float32)
    return w_rot


def _mixed_sweep(b, v, pairing):
    """One disjoint-pair rotation sweep of the double-f32 congruence
    refinement.  ``pairing`` is a static (n, n) bool mask, or None for
    dynamic mutual-max matching.  ``b`` stays exactly congruent to the
    original matrix; ``v`` accumulates the (f32) basis."""
    hp = jax.lax.Precision.HIGHEST
    w_rot = _rotation_from(b, pairing, EIGH_MIXED_F32_ROTATIONS)
    b_hi, b_lo = _split_f32(b)
    bw = _df32_apply(b_hi, b_lo, w_rot)
    b = _df32_gram(w_rot, bw)
    b = 0.5 * (b + jnp.swapaxes(b, -1, -2))
    v = jnp.matmul(v, w_rot, precision=hp)
    return b, v


def _mixed_sweep32(b32, v, pairing):
    """One refinement sweep with the congruence residual tracked in PLAIN
    float32, instead of the four f64-accumulation matmuls per sweep of the
    exact tracking (:func:`_mixed_sweep`).

    The tracked matrix only feeds ROTATION DECISIONS, which are f32-limited anyway (the basis is
    f32-stored); eigenvalue accuracy comes from ONE exact double-f32
    congruence diagonal computed at the very end
    (:func:`_exact_diag_congruence`), where the Rayleigh-quotient
    second-order property makes the f32-level off-diagonal residual
    contribute O(residual^2 / gap) — below f64 noise for every
    resolvable mode, and bounded by the (noise-dominated) residual
    itself inside quasi-degenerate clusters."""
    hp = jax.lax.Precision.HIGHEST
    w_rot = _rotation_from(b32, pairing, True)
    bw = jnp.matmul(b32, w_rot, precision=hp)
    b32 = jnp.matmul(jnp.swapaxes(w_rot, -1, -2), bw, precision=hp)
    b32 = 0.5 * (b32 + jnp.swapaxes(b32, -1, -2))
    v = jnp.matmul(v, w_rot, precision=hp)
    return b32, v


def _exact_diag_congruence(a_hi, a_lo, v):
    """``diag(v^T A v)`` to double-f32 accuracy with only TWO
    f64-accumulation matmuls: ``Av`` exactly, then an elementwise f64
    row-product reduction (no second full matmul)."""
    av = _df32_apply(a_hi, a_lo, v)  # (n, n) float64
    return jnp.einsum(
        "...ij,...ij->...j", v.astype(jnp.float64), av
    )


def _offdiag_unresolved(b):
    """True while any off-diagonal entry is above the eps64 row-relative
    threshold at which the sweeps stop rotating (the refinement's fixed
    point) — scalar over all batch dims, for a while_loop condition."""
    eps64 = float(np.finfo(np.float64).eps)
    n = b.shape[-1]
    d = jnp.diagonal(b, axis1=-2, axis2=-1)
    absd = jnp.abs(d)
    off = jnp.abs(b) * (1.0 - jnp.eye(n, dtype=b.dtype))
    return jnp.any(
        off > eps64 * (absd[..., :, None] + absd[..., None, :] + eps64)
    )


#: Track the refinement congruence exactly (double-f32, four
#: f64-accumulation matmuls per sweep) instead of in plain f32 with ONE
#: exact end diagonal.  The exact tracking is the round-3 original; the
#: f32 tracking (round 5) produces the same f64-quality spectrum — the
#: tracked matrix only feeds f32-limited rotation decisions, and the
#: final eigenvalues come from an exact congruence either way — with
#: f32 instead of f64-accumulation matmuls in every sweep.  Kept as a
#: flag for A/B and fallback.
EIGH_MIXED_EXACT_TRACK = False


def _eigh_mixed_impl(a64, identity_start: bool = False, reps: int | None = None):
    n = a64.shape[-1]
    a_hi, a_lo = _split_f32(a64)
    if identity_start:
        # near-diagonal input (e.g. a congruence to a preconditioning
        # basis): skip the f32 eigh start entirely — an f32 eigh would
        # scramble the sub-f32-eps modes of a graded spectrum, while the
        # sweeps below preserve relative structure from the identity
        v = jnp.broadcast_to(
            jnp.eye(n, dtype=jnp.float32), a_hi.shape
        ) if a_hi.ndim > 2 else jnp.eye(n, dtype=jnp.float32)
    else:
        _, v = jnp.linalg.eigh(a_hi)  # f32 basis
    m_even, m_odd = _brickwall_masks(n)
    # FIXED repetition count.  An adaptive convergence-gated loop (round-4
    # experiment) is wrong here: at temporal sizes the eps64 off-diagonal
    # fixed point is unreachable — the residual floor sits ~1e11*eps64 in
    # quasi-degenerate DEEP-spectrum pairs (measured, n=200..600) whose d
    # entries are noise-dominated downstream, so a convergence gate just
    # burns the cap while the likelihood-relevant modes were done after
    # the first repetitions.  The accuracy contract (0.055 RMS log-units
    # at the auditory size; tests/test_eigh_mixed.py) is pinned at
    # EIGH_MIXED_REPS = 2.
    pairings = [m_even, m_odd, None] * (
        EIGH_MIXED_REPS if reps is None else reps
    )
    if EIGH_MIXED_EXACT_TRACK:
        # exact double-f32 congruence tracked through every sweep
        b = _df32_gram(v, _df32_apply(a_hi, a_lo, v))
        b = 0.5 * (b + jnp.swapaxes(b, -1, -2))
        for pairing in pairings:
            b, v = _mixed_sweep(b, v, pairing)
        return jnp.diagonal(b, axis1=-2, axis2=-1), v
    # f32-tracked sweeps + ONE exact end diagonal (see _mixed_sweep32)
    hp = jax.lax.Precision.HIGHEST
    if identity_start:
        b32 = a_hi
    else:
        av = jnp.matmul(a_hi, v, precision=hp)
        b32 = jnp.matmul(jnp.swapaxes(v, -1, -2), av, precision=hp)
        b32 = 0.5 * (b32 + jnp.swapaxes(b32, -1, -2))
    for pairing in pairings:
        b32, v = _mixed_sweep32(b32, v, pairing)
    return _exact_diag_congruence(a_hi, a_lo, v), v


@jax.custom_jvp
def eigh_mixed(a64):
    """float64-quality symmetric eigendecomposition at f32-Jacobi cost.

    Primal: f32 eigh for the starting basis, then disjoint-pair exact
    Givens-rotation sweeps (even-adjacent / odd-adjacent / mutual-max
    pairings; each matched 2x2 annihilated outright — no damping) with
    the congruence residual tracked in double-f32 (f32-pair operands,
    error-free products, f64 accumulation).
    Returns ``(w float64, v float32)``; ``w`` is NOT re-sorted (order
    follows the f32 eigh; (w_i, v_i) pairs stay aligned, which is all the
    factored Kronecker likelihood needs).  Eigenvector storage in f32 is
    deliberate: *rounding* an accurate basis costs 0.0024 RMS log-units in
    the likelihood, while an f32-*computed* eigh costs ~2 RMS (PERF.md
    "f32 likelihood noise").

    Derivative: the analytic gap-regularized eigh JVP evaluated at the
    refined factors (same formula as :func:`eigh_safe`), with f32
    contractions — gradients tolerate f32 noise, values do not.
    """
    return _eigh_mixed_impl(a64)


def _mixed_eigh_jvp(fn, primals, tangents):
    """Analytic gap-regularized eigh JVP at the refined factors, with f32
    contractions (values need double-f32; gradients tolerate f32 noise)."""
    (a,) = primals
    (da,) = tangents
    w, v = fn(a)
    hp = jax.lax.Precision.HIGHEST
    da32 = (0.5 * (da + jnp.swapaxes(da, -1, -2))).astype(jnp.float32)
    vt_da_v = _mm_f64acc(
        jnp.matmul(jnp.swapaxes(v, -1, -2), da32, precision=hp), v
    )
    dw = jnp.diagonal(vt_da_v, axis1=-2, axis2=-1)
    gap = w[..., None, :] - w[..., :, None]
    scale = jnp.maximum(jnp.max(jnp.abs(w), axis=-1, keepdims=True)[..., None], 1.0)
    eps = _EIGH_GAP_EPS * scale
    f = gap / (gap * gap + eps * eps)
    f = f * (1.0 - jnp.eye(w.shape[-1], dtype=f.dtype))
    dv = jnp.matmul(
        v, (f * vt_da_v).astype(jnp.float32), precision=hp
    )
    return (w, v), (dw, dv)


@eigh_mixed.defjvp
def _eigh_mixed_jvp(primals, tangents):
    return _mixed_eigh_jvp(eigh_mixed, primals, tangents)


def _roundrobin_mask(r, n: int):
    """Round ``r`` of a parallel-Jacobi round-robin pairing family
    (circle method, closed form): a disjoint (n, n) bool mask; over
    ``r = 0..n_rounds-1`` every index pair is covered exactly once.

    Closed form instead of a precomputed ``(n_rounds, n, n)`` stack
    because the stack is a huge baked constant at temporal sizes
    (~215 MB of bool at n=600); this is O(n^2) traced arithmetic with a
    DYNAMIC round index, so it works inside while_loops.

    Why full coverage matters: the brick-wall + mutual-max schedule only
    ever visits ~3n/2 of the n(n-1)/2 pairs, which is why it stalls on
    inputs that are not already near-diagonal (measured: max relative
    off-diagonal stuck at 5e-2 after 90 sweeps at 1.05x the
    preconditioning center).
    """
    m = n if n % 2 == 0 else n + 1  # odd n: a virtual bye player
    idx = jnp.arange(n)
    ii, jj = idx[:, None], idx[None, :]
    r = jnp.asarray(r)
    # inner circle: i pairs with j when i + j = 2r (mod m-1); i = j is the
    # round's fixed point, which pairs with the last player instead
    inner = (
        (ii < m - 1)
        & (jj < m - 1)
        & (jnp.mod(ii + jj - 2 * r, m - 1) == 0)
        & (ii != jj)
    )
    if m == n:  # n even: the real last player pairs with the fixed point
        fix = jnp.mod(r, m - 1)
        last = ((ii == m - 1) & (jj == fix)) | ((jj == m - 1) & (ii == fix))
        return inner | last
    return inner  # n odd: the fixed point sits out this round


ROUNDROBIN_N_ROUNDS = lambda n: (n if n % 2 == 0 else n + 1) - 1


#: Iteration bounds for the adaptive identity-start refinement
#: (:func:`_eigh_mixed_b`).  Each iteration is one round-robin round plus
#: one mutual-max sweep; MIN covers the near-diagonal (threaded-basis)
#: case, MAX_CYCLES bounds worst-case work at ``MAX_CYCLES * (n_rounds)``
#: iterations when the input starts far from diagonal (NUTS
#: tail/divergence evaluations, SMC tempering), where the old fixed
#: 9-sweep schedule silently under-diagonalized (ADVICE r3 medium).
EIGH_MIXED_B_MIN_ITERS = 1
EIGH_MIXED_B_MAX_CYCLES = 6


@jax.custom_jvp
def _eigh_mixed_ident(a64):
    """Identity-start refinement with a FIXED repetition budget — the
    temporal variant of :func:`_eigh_mixed_b` (opt-in via
    ``config.Policy.temporal_identity_start``).  For a near-diagonal
    congruence (trajectory-threaded or posterior-local MAP basis) the f32
    eigh start of :func:`eigh_mixed` is redundant work; the brick-wall +
    mutual-max repetitions alone finish the job (measured at the auditory
    nt=600: value agrees with the f32-start path to ~1e-3 log-units).
    Fixed reps rather than the adaptive loop because the eps64 fixed
    point is unreachable at temporal sizes (see the eigh_mixed comment)."""
    return _eigh_mixed_impl(a64, identity_start=True, reps=EIGH_MIXED_REPS + 1)


@_eigh_mixed_ident.defjvp
def _eigh_mixed_ident_jvp(primals, tangents):
    return _mixed_eigh_jvp(_eigh_mixed_ident, primals, tangents)


@jax.custom_jvp
def _eigh_mixed_b(a64):
    """:func:`eigh_mixed` for near-diagonal congruences (preconditioned
    bases): identity start — no f32 eigh, which would scramble the
    sub-f32-eps modes of a graded spectrum — with disjoint-pair rotation
    sweeps run ADAPTIVELY until every off-diagonal entry is below the
    eps64 row-relative rotation threshold (the refinement's fixed point).
    Each iteration pairs a round-robin round (global coverage: all pairs
    once per ``n_rounds`` iterations, the classical parallel Jacobi
    ordering, globally convergent) with a mutual-max sweep (greedy local
    acceleration).  Near the center this converges in ~2-3 iterations;
    far from the center it keeps sweeping to the same fixed point instead
    of returning the diagonal of an under-diagonalized matrix (ADVICE r3
    medium; exercised by ``tests/test_eigh_mixed.py::TestEighMixedB``)."""
    n = a64.shape[-1]
    b = 0.5 * (a64 + jnp.swapaxes(a64, -1, -2))
    v = (
        jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), b.shape)
        if b.ndim > 2
        else jnp.eye(n, dtype=jnp.float32)
    )
    # VMA seeding (shard_map): the identity start and the iteration counter
    # are replicated while ``b`` is device-varying, but the while_loop body
    # makes both varying (v rotates with b; per-device trip counts differ),
    # so the carry must ENTER with the varying type — the repo-standard
    # ``+ 0*sum(varying)`` trick (see infer/nuts.py VMA seeds)
    vz = 0.0 * jnp.sum(b)
    v = v + vz.astype(jnp.float32)
    it0 = jnp.zeros((), jnp.int32) + vz.astype(jnp.int32)
    n_rounds = ROUNDROBIN_N_ROUNDS(n)
    # absolute bound on top of the cycle cap: this path is designed for
    # SMALL graded matrices (spatial Grams, n <= ~128) where the eps64
    # fixed point is reachable; at temporal sizes the criterion is not
    # (see the eigh_mixed comment) and an uncapped loop would burn
    # thousands of sweeps
    max_iters = min(EIGH_MIXED_B_MAX_CYCLES * n_rounds, 256)

    def body(state):
        b, v, it = state
        b, v = _mixed_sweep(b, v, _roundrobin_mask(jnp.mod(it, n_rounds), n))
        b, v = _mixed_sweep(b, v, None)
        return b, v, it + 1

    def cond(state):
        b, _, it = state
        return (it < EIGH_MIXED_B_MIN_ITERS) | (
            _offdiag_unresolved(b) & (it < max_iters)
        )

    b, v, _ = jax.lax.while_loop(cond, body, (b, v, it0))
    return jnp.diagonal(b, axis1=-2, axis2=-1), v


@_eigh_mixed_b.defjvp
def _eigh_mixed_b_jvp(primals, tangents):
    return _mixed_eigh_jvp(_eigh_mixed_b, primals, tangents)


# ---------------------------------------------------------------------------
# factored Kronecker likelihood
# ---------------------------------------------------------------------------


class KronFactors(NamedTuple):
    """Factorization of ``K = Ks (x) Kt + diag(noise)`` such that

        K^{-1} = (qs (x) qt) diag(1/d) (qs (x) qt)^T
        log|K| = sum(log d) + logdet_offset

    In the homoscedastic / reference-approximation path ``qs``/``qt`` are the
    orthogonal eigenvectors of Ks/Kt and ``logdet_offset`` is zero.  In the
    exact heteroscedastic path (``het_exact=True``) ``qs = S^{-1} Q̃`` is the
    noise-whitened spatial basis (not orthogonal) and ``logdet_offset``
    carries ``nt * sum(log sig2n)``; every downstream identity (whiten,
    loglik quad form, kron_solve, posterior variance) holds unchanged.
    """

    qs: jnp.ndarray  # (nx, nx)
    qt: jnp.ndarray  # (nt, nt)
    lam_s: jnp.ndarray  # (nx,)
    lam_t: jnp.ndarray  # (nt,)
    d: jnp.ndarray  # (nx, nt) diagonal in the (qs (x) qt) basis
    logdet_offset: jnp.ndarray = 0.0  # scalar, see class docstring


#: Under the float32 factor policy, matrices smaller than this are
#: eigendecomposed in full float64 instead of by :func:`eigh_mixed`.
MIXED_EIGH_MIN_N = 257


def _factor_eigh(K):
    """Eigendecomposition at the factor policy's accuracy.

    float64 policy (the default): exact ``eigh``.  float32 policy:
    :func:`eigh_mixed` — f32 basis + double-f32 spectrum, which removes
    most of the evaluation noise a plain f32 eigh puts into the
    likelihood.
    """
    from .. import config

    fdt = config.get_policy().resolve_factor_dtype()
    K = jnp.asarray(K)
    if fdt == jnp.float64:
        return eigh_safe(K.astype(fdt))
    if K.shape[-1] < MIXED_EIGH_MIN_N:
        # small graded matrices (the spatial quadrature Gram: 14+ decades
        # of spectrum at nx=24) defeat an f32-basis start entirely — the
        # sub-f32-eps modes begin as noise directions; full f64 is cheap
        # at this size
        return eigh_safe(K.astype(jnp.float64))
    return eigh_mixed(K.astype(jnp.float64))


def _spatial_factors(Ks, sig2n, nt, het_exact):
    """Spatial eigenbasis + per-entry noise floor + logdet offset.

    ``het_exact=False`` reproduces the reference approximation for vector
    sig2n (D built in the eigenbasis of Ks alone,
    ``/root/reference/src/gpcsd/utility_functions.py:54-63``).
    ``het_exact=True`` whitens by the noise first: with ``S = diag(sig2n)``,

        K = Ks (x) Kt + S (x) I
          = (S^{1/2} (x) I)(S^{-1/2} Ks S^{-1/2} (x) Kt + I)(S^{1/2} (x) I)

    so eigendecomposing the whitened ``K̃s = S^{-1/2} Ks S^{-1/2}`` gives the
    *exact* diagonalization at identical cost (one nx-sized eigh).  For
    scalar sig2n both paths are the same exact factorization.
    """
    eigh_in = Ks
    if het_exact and sig2n.ndim:
        s = jnp.sqrt(sig2n)
        eigh_in = Ks / (s[:, None] * s[None, :])
    lam_s, qs = _factor_eigh(eigh_in)
    # The kernels are PSD + jitter, so true eigenvalues are nonnegative;
    # numerically negative ones (quadrature Gram roundoff, ~eps*||K||) would
    # push D below the noise floor and NaN the log-determinant.
    lam_s = jnp.maximum(lam_s, 0.0)
    if het_exact and sig2n.ndim:
        qs = qs / s[:, None]
        noise = jnp.ones((), Ks.dtype)
        logdet_offset = nt * jnp.sum(jnp.log(sig2n))
    else:
        noise = sig2n[..., None] if sig2n.ndim else sig2n
        logdet_offset = jnp.zeros((), Ks.dtype)
    return qs, lam_s, noise, logdet_offset


def comp_eig_d(Ks, Kt, sig2n, het_exact: bool = False) -> KronFactors:
    """Joint factorization; ``sig2n`` is a scalar or per-channel (nx,) vector.

    Matches reference ``comp_eig_D`` with D reshaped to (nx, nt): the
    reference's flat ``Dvec`` is ``repeat(lam_s, nt)*tile(lam_t, nx)+sig2n``
    i.e. row-major (nx, nt) — identical layout.  Factors are computed in the
    policy factor dtype (float64 unless :func:`gpcsd_tpu.config.set_policy`
    says otherwise).

    :param het_exact: with vector sig2n, use the exact noise-whitened
        factorization instead of the reference's approximation (SURVEY.md §5);
        no-op for scalar sig2n.
    """
    from .. import config

    fdt = config.get_policy().resolve_factor_dtype()
    # mixed mode (f32 policy): covariances and the spectrum
    # stay float64 — only the eigenbasis is f32 (see eigh_mixed); rounding
    # K itself to f32 alone injects ~1.5 RMS log-units of likelihood noise
    kdt = jnp.float64 if fdt == jnp.float32 else fdt
    Ks = jnp.asarray(Ks).astype(kdt)
    Kt = jnp.asarray(Kt).astype(kdt)
    sig2n = jnp.asarray(sig2n).astype(kdt)
    lam_t, qt = _factor_eigh(Kt)
    lam_t = jnp.maximum(lam_t, 0.0)
    qs, lam_s, noise, logdet_offset = _spatial_factors(
        Ks, sig2n, lam_t.shape[0], het_exact
    )
    d = lam_s[:, None] * lam_t[None, :] + noise
    return KronFactors(
        qs=qs, qt=qt, lam_s=lam_s, lam_t=lam_t, d=d, logdet_offset=logdet_offset
    )


def comp_eig_d_preconditioned(
    Ks, Kt, sig2n, q0t, het_exact: bool = False, q0s=None
) -> KronFactors:
    """:func:`comp_eig_d` with the temporal eigh solved in a fixed reference
    basis ``q0t`` (typically the MAP's eigenvectors).

    ``B = q0t^T Kt q0t`` is nearly diagonal near the reference point, which
    the refinement sweeps of the float32 policy's :func:`eigh_mixed` exploit;
    the result is the exact eigendecomposition everywhere (``Qt = q0t W``).
    """
    from .. import config

    fdt = config.get_policy().resolve_factor_dtype()
    hp = jax.lax.Precision.HIGHEST
    if fdt == jnp.float32:
        # mixed mode: K stays f64; the congruence B = q0^T Kt q0 runs in
        # double-f32 (error-free f32 products, f64 accumulation) so B's
        # spectrum carries Kt's to ~1e-14 relative, then eigh_mixed pins
        # eigenvalues in f64 with an f32-stored basis.  q0's own f32
        # rounding is a benign near-orthogonal congruence (relative
        # eigenvalue perturbation ~1e-7; measured harmless in the probe).
        Ks = jnp.asarray(Ks).astype(jnp.float64)
        Kt = jnp.asarray(Kt).astype(jnp.float64)
        sig2n = jnp.asarray(sig2n).astype(jnp.float64)
        q032 = jnp.asarray(q0t).astype(jnp.float32)
        kt_hi, kt_lo = _split_f32(Kt)
        B = _df32_gram(q032, _df32_apply(kt_hi, kt_lo, q032))
        B = 0.5 * (B + jnp.swapaxes(B, -1, -2))
        if config.get_policy().temporal_identity_start:
            # the congruence to a threaded/MAP basis is already
            # near-diagonal: skip the f32-eigh start entirely and let the
            # fixed-budget identity-start refinement finish it (opt-in,
            # see config.Policy.temporal_identity_start)
            lam_t, w_t = _eigh_mixed_ident(B)
        else:
            lam_t, w_t = eigh_mixed(B)
        qt = jnp.matmul(q032, w_t, precision=hp)
        lam_t = jnp.maximum(lam_t, 0.0)
        if q0s is not None and not (het_exact and sig2n.ndim):
            # spatial preconditioning (same congruence trick): in a fixed
            # f64-accurate MAP basis the congruence is near-diagonal with
            # RELATIVE structure intact, so identity-start double-f32
            # sweeps finish it with a handful of tiny matmuls
            q0s32 = jnp.asarray(q0s).astype(jnp.float32)
            ks_hi, ks_lo = _split_f32(Ks)
            Bs = _df32_gram(q0s32, _df32_apply(ks_hi, ks_lo, q0s32))
            Bs = 0.5 * (Bs + jnp.swapaxes(Bs, -1, -2))
            lam_s, w_s = _eigh_mixed_b(Bs)
            qs = jnp.matmul(q0s32, w_s, precision=hp)
            lam_s = jnp.maximum(lam_s, 0.0)
            if sig2n.ndim:
                noise = sig2n[..., None]
            else:
                noise = sig2n
            logdet_offset = jnp.zeros((), Ks.dtype)
        else:
            qs, lam_s, noise, logdet_offset = _spatial_factors(
                Ks, sig2n, lam_t.shape[0], het_exact
            )
        d = lam_s[:, None] * lam_t[None, :] + noise
        return KronFactors(
            qs=qs, qt=qt, lam_s=lam_s, lam_t=lam_t, d=d,
            logdet_offset=logdet_offset,
        )
    Ks = jnp.asarray(Ks).astype(fdt)
    Kt = jnp.asarray(Kt).astype(fdt)
    q0t = jnp.asarray(q0t).astype(fdt)
    sig2n = jnp.asarray(sig2n).astype(fdt)
    B = jnp.matmul(jnp.matmul(q0t.T, Kt, precision=hp), q0t, precision=hp)
    lam_t, w_t = eigh_safe(B)
    qt = jnp.matmul(q0t, w_t, precision=hp)
    lam_t = jnp.maximum(lam_t, 0.0)
    qs, lam_s, noise, logdet_offset = _spatial_factors(
        Ks, sig2n, lam_t.shape[0], het_exact
    )
    d = lam_s[:, None] * lam_t[None, :] + noise
    return KronFactors(
        qs=qs, qt=qt, lam_s=lam_s, lam_t=lam_t, d=d, logdet_offset=logdet_offset
    )


def whiten(factors: KronFactors, Y):
    """``alpha = Qs^T Y Qt`` batched over leading axes; Y is (..., nx, nt).

    The contraction runs in the policy compute dtype (float64 by default;
    the eigenbasis and the D-weighted reduction stay in the factor dtype).
    """
    from .. import config

    cdt = config.get_policy().resolve_compute_dtype()
    Y = jnp.asarray(Y)
    out_dtype = jnp.result_type(Y.dtype, factors.qs.dtype)
    alpha = jnp.einsum(
        "xi,...xt,tj->...ij",
        factors.qs.astype(cdt),
        Y.astype(cdt),
        factors.qt.astype(cdt),
        precision=jax.lax.Precision.HIGHEST,
    )
    return alpha.astype(out_dtype)


def loglik(factors: KronFactors, Y, ntrials=None):
    """Marginal log-likelihood of trials Y (..., nx, nt); sums trial axes.

    Drops the -0.5*n*log(2*pi) constant, matching reference ``loglik``
    (``gpcsd1d.py:113-128``).

    :param ntrials: override the trial count in the log-determinant term —
        used when Y carries zero-padded trials for sharding (padded trials
        contribute exactly zero to the quadratic form).
    """
    Y = jnp.asarray(Y)
    if ntrials is None:
        ntrials = 1
        for s in Y.shape[:-2]:
            ntrials *= s
    alpha = whiten(factors, Y)
    quad = jnp.sum(jnp.square(alpha) / factors.d)
    logdet = ntrials * (jnp.sum(jnp.log(factors.d)) + factors.logdet_offset)
    return -0.5 * (logdet + quad)


def kron_solve(factors: KronFactors, Y):
    """``(Ks (x) Kt + diag(sig2n))^{-1} Y`` per trial, fully factored.

    Y is (..., nx, nt); returns the same shape.  Replaces the reference's
    dense ``mykron(Qs, Qt) @ diag(1/D) @ ...`` (``gpcsd1d.py:262-265``).
    """
    from .. import config

    cdt = config.get_policy().resolve_compute_dtype()
    alpha = whiten(factors, Y) / factors.d
    out = jnp.einsum(
        "xi,...ij,tj->...xt",
        factors.qs.astype(cdt),
        alpha.astype(cdt),
        factors.qt.astype(cdt),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(alpha.dtype)


def kron_cross_mean(Kxz, Ktt, V):
    """Posterior mean contraction ``(Kxz (x) Ktt)^T vec(V)`` per trial.

    :param Kxz: (nx, nz) spatial cross-covariance (data side first)
    :param Ktt: (nt, ntstar) temporal cross-covariance (data side first)
    :param V: (..., nx, nt) solve output from :func:`kron_solve`
    :return: (..., nz, ntstar)
    """
    from .. import config

    cdt = config.get_policy().resolve_compute_dtype()
    V = jnp.asarray(V)
    out = jnp.einsum(
        "xz,...xt,ts->...zs",
        jnp.asarray(Kxz).astype(cdt),
        V.astype(cdt),
        jnp.asarray(Ktt).astype(cdt),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.astype(V.dtype)


def orth_polish(q):
    """One Newton-Schulz step toward the nearest orthogonal matrix.

    Used to pin the orthogonality defect of a *carried* eigenbasis (the
    NUTS warm-start aux state) at the roundoff floor: each leapfrog
    multiplies two approximately-orthogonal f32 factors, so over thousands
    of steps the defect would grow linearly and bias the factorization
    identity ``K^{-1} = qt d^{-1} qt^T``.
    """
    hp = jax.lax.Precision.HIGHEST
    return 1.5 * q - 0.5 * jnp.matmul(
        q, jnp.matmul(q.T, q, precision=hp), precision=hp
    )


def mykron(A, B):
    """Dense Kronecker product (kept for tests/interop; avoid in hot paths)."""
    a1, a2 = A.shape
    b1, b2 = B.shape
    return jnp.reshape(
        A[:, None, :, None] * B[None, :, None, :], (a1 * b1, a2 * b2)
    )
