"""Parallel-order cyclic Jacobi symmetric eigensolver in pure JAX.

Not on the likelihood path: ``kronlik.eigh_safe`` calls ``jnp.linalg.eigh``
(LAPACK / cuSOLVER).  This solver is kept as an explicitly callable
alternative and a relative-accuracy reference on graded spectra.  It is
built purely from *static* strided slices, elementwise math, and one fixed
permutation — no dynamic gathers, no unrolling.

Algorithm: cyclic Jacobi with the round-robin ("circle method") parallel
ordering.  The matrix is kept in a rotating layout in which the current
n/2 pivot pairs are always the adjacent index pairs (2i, 2i+1):

- rotate all pairs simultaneously (2x2 symmetric Schur decompositions,
  vectorized over pairs; strided slices only);
- advance to the next round's pairing by ONE fixed permutation (the same
  static index array every step — the circle method's rotation);
- after n-1 steps every pair has been pivoted once and the layout returns
  to the identity, so sweeps compose cleanly inside a ``while_loop``.

Convergence is quadratic; iteration stops when the off-diagonal Frobenius
norm drops below machine-eps * ||A||_F or at ``max_sweeps``.

Precision note: Jacobi delivers high *relative* accuracy for small
eigenvalues — exactly what the Kronecker likelihood needs when sig2n
floors D at 1e-8 (reference ``gpcsd1d.py:17``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _interleave_cols(X, Y):
    n, m = X.shape
    return jnp.stack([X, Y], axis=2).reshape(n, 2 * m)


def _interleave_rows(X, Y):
    m, n = X.shape
    return jnp.stack([X, Y], axis=1).reshape(2 * m, n)


def _circle_layout(players):
    n = len(players)
    out = []
    for i in range(n // 2):
        out.append(players[i])
        out.append(players[n - 1 - i])
    return out


def _step_permutation(n: int) -> np.ndarray:
    """sigma with B_next = B[sigma][:, sigma]: one circle-method rotation."""
    p0 = list(range(n))
    p1 = [p0[0], p0[-1]] + p0[1:-1]
    L0 = _circle_layout(p0)
    L1 = _circle_layout(p1)
    pos0 = {pl: i for i, pl in enumerate(L0)}
    return np.array([pos0[pl] for pl in L1], dtype=np.int32)


def _initial_layout(n: int) -> np.ndarray:
    return np.array(_circle_layout(list(range(n))), dtype=np.int32)


@partial(jax.jit, static_argnames=("max_sweeps", "use_matmul"))
def _eigh_jacobi_even(A, sigma, tol, max_sweeps: int, use_matmul: bool = False):
    """Core sweep loop.

    ``use_matmul=False``: strided-slice updates (exact in the input dtype;
    best on CPU / for f64 exactness).
    ``use_matmul=True``: each step applies the n/2 disjoint rotations AND
    the schedule permutation as a single dense orthogonal matrix, so the
    whole step is two (three with eigenvectors) matmuls.
    """
    n = A.shape[-1]
    dtype = A.dtype
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    tol = jnp.asarray(tol, dtype)
    nsteps = n - 1
    inv_sigma = jnp.argsort(sigma)

    def offnorm(M):
        return jnp.linalg.norm(M - jnp.diagflat(jnp.diagonal(M)))

    def rotations(B):
        d = jnp.diagonal(B)
        app = d[0::2]
        aqq = d[1::2]
        apq = jnp.diagonal(B, offset=1)[0::2]
        small = jnp.abs(apq) <= eps * (jnp.abs(app) + jnp.abs(aqq) + eps)
        tau = (aqq - app) / (2.0 * jnp.where(small, 1.0, apq))
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        c = jnp.where(small, 1.0, c)
        s = jnp.where(small, 0.0, s)
        return c, s

    def step_slices(_, BV):
        B, V = BV
        c, s = rotations(B)
        Bt = B[:, 0::2]
        Bb = B[:, 1::2]
        B = _interleave_cols(c[None, :] * Bt - s[None, :] * Bb,
                             s[None, :] * Bt + c[None, :] * Bb)
        Bt = B[0::2, :]
        Bb = B[1::2, :]
        B = _interleave_rows(c[:, None] * Bt - s[:, None] * Bb,
                             s[:, None] * Bt + c[:, None] * Bb)
        Vt = V[:, 0::2]
        Vb = V[:, 1::2]
        V = _interleave_cols(c[None, :] * Vt - s[None, :] * Vb,
                             s[None, :] * Vt + c[None, :] * Vb)
        # advance to the next round's pairing (fixed static permutation)
        B = B[sigma][:, sigma]
        V = V[:, sigma]
        return B, V

    diag_idx = jnp.arange(n)
    even = jnp.arange(0, n, 2)
    odd = even + 1

    def step_matmul(_, BV):
        B, V = BV
        c, s = rotations(B)
        # dense block-diagonal rotation J (2x2 blocks on adjacent pairs),
        # with the schedule permutation folded into its columns:
        # G = J @ P^T  so  B <- G^T B G  both rotates and re-lays-out.
        cd = jnp.zeros((n,), dtype).at[even].set(c).at[odd].set(c)
        J = jnp.zeros((n, n), dtype)
        J = J.at[diag_idx, diag_idx].set(cd)
        J = J.at[even, odd].set(s).at[odd, even].set(-s)
        G = J[:, sigma]
        # HIGHEST precision: reduced-precision passes (TF32) destroy the
        # rotation accumulation over thousands of steps
        hp = jax.lax.Precision.HIGHEST
        B = jnp.matmul(jnp.matmul(G.T, B, precision=hp), G, precision=hp)
        V = jnp.matmul(V, G, precision=hp)
        return B, V

    step = step_matmul if use_matmul else step_slices

    def sweep_body(state):
        B, V, it, nstall = state
        before = offnorm(B)
        B, V = jax.lax.fori_loop(0, nsteps, step, (B, V))
        B = 0.5 * (B + B.T)
        stalled_now = offnorm(B) >= 0.9 * before
        nstall = jnp.where(stalled_now, nstall + 1, 0)
        return B, V, it + 1, nstall

    def sweep_cond(state):
        B, _, it, nstall = state
        off = offnorm(B)
        # stall exit: near the noise floor (within 10x of tol) one
        # low-progress sweep means done; FAR from tol require two
        # consecutive <10% sweeps — Jacobi has no guaranteed per-sweep
        # rate, so a single slow sweep is not the floor, but persistent
        # stalling means extra sweeps only burn time (and unbounded
        # sweep counts blow up worst-case device dispatch time)
        stalled = ((nstall >= 1) & (off < 10.0 * tol)) | (nstall >= 2)
        return (off > tol) & ~stalled & (it < max_sweeps)

    # start in circle layout L0 so pairs are adjacent
    L0 = jnp.asarray(_initial_layout(n))
    B0 = A[L0][:, L0]
    B0 = 0.5 * (B0 + B0.T)
    V0 = jnp.zeros((n, n), dtype).at[L0, jnp.arange(n)].set(1.0)

    B, V, _, _ = jax.lax.while_loop(
        sweep_cond, sweep_body, (B0, V0, 0, jnp.zeros((), jnp.int32))
    )
    # after full sweeps the layout is back to L0; undo it
    inv = jnp.argsort(L0)
    w = jnp.diagonal(B)[inv]
    V = V[:, inv]
    order = jnp.argsort(w)
    return w[order], V[:, order]


@partial(jax.jit, static_argnames=("nb", "max_sweeps"))
def _eigh_block_jacobi(A, tol, nb: int, max_sweeps: int):
    """Two-sided block-Jacobi with the circle schedule at BLOCK granularity.

    Each step diagonalizes nb/2 disjoint 2b x 2b pair subproblems with one
    *batched* ``eigh``, applies all of them plus the schedule permutation as
    one dense orthogonal matmul, and re-lays-out.  A sweep is only nb-1
    sequential steps — two orders of magnitude fewer than scalar Jacobi.

    Requires n divisible by nb and nb even (callers pad).
    """
    n = A.shape[-1]
    dtype = A.dtype
    b = n // nb
    m = nb // 2  # pair count
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    tol = jnp.asarray(tol, dtype)
    hp = jax.lax.Precision.HIGHEST

    # element-level permutation from the block-level circle rotation
    sigma_b = _step_permutation(nb)
    sigma_el = jnp.asarray(
        (sigma_b[:, None] * b + np.arange(b)[None, :]).reshape(-1)
    )
    L0_b = _initial_layout(nb)
    L0_el = jnp.asarray((L0_b[:, None] * b + np.arange(b)[None, :]).reshape(-1))

    ar = jnp.arange(m)

    def offnorm(M):
        return jnp.linalg.norm(M - jnp.diagflat(jnp.diagonal(M)))

    def step(_, BV):
        B, V = BV
        # diagonal 2b x 2b pair slabs
        B4 = B.reshape(m, 2 * b, m, 2 * b)
        S = B4[ar, :, ar, :]  # (m, 2b, 2b)
        S = 0.5 * (S + jnp.swapaxes(S, -1, -2))
        _, Q = jnp.linalg.eigh(S)  # batched small eigh
        # Reorder each Q's columns toward the identity (dominant-row order,
        # positive diagonal).  eigh's eigenvalue-sorted columns are an
        # arbitrary large rotation; cyclic block-Jacobi only converges with
        # near-identity ("inner") rotations — without this the off-diagonal
        # mass just bounces between blocks.
        dom = jnp.argmax(jnp.abs(Q), axis=1)
        order = jnp.argsort(dom, axis=1)
        Q = jnp.take_along_axis(Q, order[:, None, :], axis=2)
        diag = jnp.diagonal(Q, axis1=1, axis2=2)
        Q = Q * jnp.sign(jnp.where(diag == 0, 1.0, diag))[:, None, :]
        # block-diagonal rotation, schedule permutation folded into columns
        G4 = jnp.zeros((m, 2 * b, m, 2 * b), dtype)
        G4 = G4.at[ar, :, ar, :].set(Q)
        G = G4.reshape(n, n)[:, sigma_el]
        B = jnp.matmul(jnp.matmul(G.T, B, precision=hp), G, precision=hp)
        V = jnp.matmul(V, G, precision=hp)
        return B, V

    def sweep_body(state):
        B, V, it, nstall = state
        before = offnorm(B)
        B, V = jax.lax.fori_loop(0, nb - 1, step, (B, V))
        B = 0.5 * (B + B.T)
        stalled_now = offnorm(B) >= 0.9 * before
        nstall = jnp.where(stalled_now, nstall + 1, 0)
        return B, V, it + 1, nstall

    def sweep_cond(state):
        B, _, it, nstall = state
        off = offnorm(B)
        # stall exit: one low-progress sweep at the f32 rotation-noise
        # floor (within 10x of tol) means further sweeps only add noise
        # (Rayleigh refinement fixes the eigenvalues anyway); far from tol
        # require two consecutive stalls so slow-but-real convergence keeps
        # sweeping while worst-case dispatch time stays bounded
        stalled = ((nstall >= 1) & (off < 10.0 * tol)) | (nstall >= 2)
        return (off > tol) & ~stalled & (it < max_sweeps)

    B0 = A[L0_el][:, L0_el]
    B0 = 0.5 * (B0 + B0.T)
    V0 = jnp.zeros((n, n), dtype).at[L0_el, jnp.arange(n)].set(1.0)

    B, V, _, _ = jax.lax.while_loop(
        sweep_cond, sweep_body, (B0, V0, 0, jnp.zeros((), jnp.int32))
    )
    inv = jnp.argsort(L0_el)
    w = jnp.diagonal(B)[inv]
    V = V[:, inv]
    order = jnp.argsort(w)
    return w[order], V[:, order]


def _eigh_simjac(A, tol, max_iters: int):
    """Damped simultaneous-Jacobi refinement: all pair rotations at once as
    ONE dense orthogonal matmul per iteration.

    Builds the antisymmetric tangent matrix ``E_ij = t(tau_ij)`` from the
    exact 2x2 Jacobi angles (``tau = (d_j - d_i) / 2 B_ij``), damps it so
    ``I + E`` stays well-conditioned, re-orthogonalizes with two
    Newton-Schulz steps, and applies ``B <- W^T B W``.  Near a diagonal
    matrix the damping is inactive and convergence is quadratic — 2-3
    iterations of ~7 matmuls, with **no** small-eigh batch per step —
    suited to near-diagonal congruences such as ``B = Q0^T Kt Q0`` in a
    MAP-centered basis.

    Far from diagonal the overlapping simultaneous rotations fight each
    other, so the loop bails out (heavy damping => no progress) and the
    caller falls through to the guaranteed block-Jacobi sweeps.

    Returns (B, V, iters) with ``A = V B V^T``, B as diagonal as achieved.
    """
    n = A.shape[-1]
    dtype = A.dtype
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    tol = jnp.asarray(tol, dtype)
    hp = jax.lax.Precision.HIGHEST
    eye = jnp.eye(n, dtype=dtype)

    def offnorm(M):
        return jnp.linalg.norm(M - jnp.diagflat(jnp.diagonal(M)))

    def body(state):
        B, V, it, _, _ = state
        prev = offnorm(B)
        d = jnp.diagonal(B)
        c = B - jnp.diagflat(d)
        absd = jnp.abs(d)
        small = jnp.abs(c) <= eps * (absd[:, None] + absd[None, :] + eps)
        gap = d[None, :] - d[:, None]
        tau = gap / (2.0 * jnp.where(small, 1.0, c))
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        t = jnp.where(small, 0.0, t)
        # exact antisymmetry (the tau==0 45-degree fill would otherwise put
        # +1 in BOTH triangles and wreck the orthogonality of I+E): build
        # from the strict upper triangle only
        E = jnp.triu(t, k=1)
        E = E - E.T
        fro = jnp.linalg.norm(E)
        # damp so ||E|| <= 0.4: three Newton-Schulz steps then orthogonalize
        # I+E to ~1e-8 defect (the defect accumulates multiplicatively into
        # V, so it must sit at the f32 noise floor); heavy damping means the
        # iteration cannot make progress -> bail to the block-Jacobi fallback
        E = E * jnp.minimum(1.0, 0.4 / (fro + eps))
        bail = fro > 1.5
        W = eye + E
        for _ in range(3):  # Newton-Schulz toward the nearest orthogonal
            W = jnp.matmul(
                W, 1.5 * eye - 0.5 * jnp.matmul(W.T, W, precision=hp),
                precision=hp,
            )
        B = jnp.matmul(jnp.matmul(W.T, B, precision=hp), W, precision=hp)
        B = 0.5 * (B + B.T)
        V = jnp.matmul(V, W, precision=hp)
        return B, V, it + 1, bail, prev

    def cond(state):
        B, _, it, bail, prev = state
        off = offnorm(B)
        # stop on stall (off-norm no longer shrinking: the f32 rotation
        # noise floor) as well as on convergence
        return (off > tol) & (off < 0.9 * prev) & (it < max_iters) & ~bail

    B, V, it, _, _ = jax.lax.while_loop(
        cond, body, (A, eye, 0, False, jnp.asarray(jnp.inf, dtype))
    )
    return B, V, it


#: max small-eigh block size for the block solver (2b <= this)
BLOCK_EIGH_MAX = 256


def _block_partition(n: int):
    """Choose (n_padded, nb) with nb even, n_padded % nb == 0, 2b <= 256."""
    # smallest even nb with block pair size 2*(n/nb) <= BLOCK_EIGH_MAX
    nb = 2
    while True:
        npad = ((n + nb - 1) // nb) * nb
        if 2 * (npad // nb) <= BLOCK_EIGH_MAX:
            return npad, nb
        nb += 2


def _pad_decoupled(A, npad):
    """Extend A with decoupled dummy dimensions whose eigenvalues exceed the
    Gershgorin bound (distinct, so they sort strictly last).

    The bound must be *tight*: pad entries enter the f32 rotation matmuls,
    and their magnitude multiplies the roundoff that leaks into the real
    eigenpairs (a 2n*max|A| pad costs ~2 digits of accuracy at n=600).  The
    max-row-sum Gershgorin bound is rigorous and typically within a small
    factor of lambda_max."""
    n = A.shape[-1]
    big = 1.05 * jnp.max(jnp.sum(jnp.abs(A), axis=-1)) + 1.0
    extra = big * (1.0 + 0.01 * jnp.arange(npad - n, dtype=A.dtype))
    Ap = jnp.zeros((npad, npad), A.dtype)
    Ap = Ap.at[:n, :n].set(A)
    Ap = Ap.at[jnp.arange(n, npad), jnp.arange(n, npad)].set(extra)
    return Ap


def _refine_eigenvalues(A32, V32, out_dtype):
    """High-precision Rayleigh quotients w_i = v_i^T A v_i from f32 factors
    (f32 multiplies, exact in f64, with f64 accumulation)."""
    AV = jnp.matmul(A32.astype(jnp.float64), V32.astype(jnp.float64))
    w = jnp.sum(V32.astype(jnp.float64) * AV, axis=0)
    return w.astype(out_dtype)


@partial(jax.jit, static_argnames=("nb", "max_sweeps", "max_dm_iters"))
def _eigh_auto_core(A32, tol, nb: int, max_sweeps: int, max_dm_iters: int):
    """Simultaneous-Jacobi fast path + block-Jacobi fallback (both in one
    program; the fallback's while_loop exits immediately when the fast path
    already converged)."""
    hp = jax.lax.Precision.HIGHEST
    B, V, _ = _eigh_simjac(A32, tol, max_dm_iters)
    _, V2 = _eigh_block_jacobi(B, tol, nb, max_sweeps)
    return jnp.matmul(V, V2, precision=hp)


def eigh_jacobi(A, max_sweeps: int = 20, method: str | None = None):
    """Symmetric eigendecomposition, ascending eigenvalues (eigh convention).

    :param method: 'slices' (strided updates, full input precision — the
        default), 'auto' (simultaneous-Jacobi matmul refinement with
        block-Jacobi fallback, float32 internal with float64 Rayleigh
        eigenvalue refinement; fastest on near-diagonal inputs),
        'block' (batched 2b x 2b subproblem eighs + one dense rotation
        matmul per step, float32 internal), 'matmul' (dense 2x2 rotation
        matmuls, float32 internal), or None for 'slices'.
    """
    A = jnp.asarray(A)
    n = A.shape[-1]
    if method is None:
        method = "slices"

    if method in ("block", "auto"):
        npad, nb = _block_partition(n)
        Ap = _pad_decoupled(A, npad) if npad != n else A
        in_dtype = A.dtype
        A32 = Ap.astype(jnp.float32)
        # convergence tolerance from the UNPADDED norm: the decoupling pad's
        # Gershgorin-exceeding diagonal would otherwise inflate it and stop
        # the sweeps early (the pad itself contributes no off-diagonal mass).
        # The sqrt(n) factor is the f32 rotation-noise floor: every dense
        # n^3 rotation matmul reinjects ~eps*||A||*sqrt(n) of off-diagonal
        # mass, so a tighter tol is unreachable and only burns sweeps (the
        # stall exits below catch it anyway; this makes the common case
        # terminate on the tol test directly)
        tol = (
            jnp.float32(np.finfo(np.float32).eps)
            * jnp.linalg.norm(A.astype(jnp.float32))
            * (1.0 + 0.25 * np.sqrt(n))
        )
        if method == "auto":
            V32 = _eigh_auto_core(A32, tol, nb, max_sweeps, max_dm_iters=8)
        else:
            _, V32 = _eigh_block_jacobi(A32, tol, nb, max_sweeps)
        w = _refine_eigenvalues(A32, V32, in_dtype)
        order = jnp.argsort(w)
        w = w[order]
        V = V32.astype(in_dtype)[:, order]
        return w[:n] if npad != n else w, V[:n, :n] if npad != n else V

    npad = n + (n % 2)
    Ap = _pad_decoupled(A, npad) if npad != n else A
    sigma = jnp.asarray(_step_permutation(npad))
    if method == "slices":
        tol = np.finfo(np.dtype(A.dtype)).eps * jnp.linalg.norm(A)
        w, V = _eigh_jacobi_even(Ap, sigma, tol, max_sweeps, use_matmul=False)
    elif method == "matmul":
        in_dtype = A.dtype
        A32 = Ap.astype(jnp.float32)
        tol = (
            jnp.float32(np.finfo(np.float32).eps)
            * jnp.linalg.norm(A.astype(jnp.float32))
            * (1.0 + 0.25 * np.sqrt(n))
        )
        _, V32 = _eigh_jacobi_even(A32, sigma, tol, max_sweeps, use_matmul=True)
        w = _refine_eigenvalues(A32, V32, in_dtype)
        order = jnp.argsort(w)
        w, V = w[order], V32.astype(in_dtype)[:, order]
    else:
        raise ValueError(f"unknown method {method!r}")
    if npad != n:
        return w[:n], V[:n, :n]
    return w, V
