"""Torus graph: exponential-family graphical model for multivariate phases.

Subsumes the reference's external dependency ``pyTG.torusGraphs`` (used at
``/root/reference/auditory_lfp/torus_graph_fit.py:31-38,55-56`` and
``/root/reference/neuropixels/fit_torus_graph.py:34-37``): a pairwise
exponential-family density on the d-torus (Klein, Orellana, Brincat, Miller
& Kass, AOAS 2020),

    p(x | phi) = exp(phi^T S(x)) / Z(phi),   x in [0, 2pi)^d

with sufficient statistics selected by ``sel_mode = (marginals,
differences, sums)``:
- marginals: cos x_j, sin x_j                       (2 per node)
- differences: cos(x_j - x_k), sin(x_j - x_k)      (2 per pair)
- sums: cos(x_j + x_k), sin(x_j + x_k)             (2 per pair)

The phase-differences submodel used throughout the GPCSD paper is
``sel_mode=(False, True, False)``.

Estimation is score matching, which is *closed form* for this family: with
per-sample estimating function g(x; phi) = G(x) phi - H(x), where
G(x) = grad_S grad_S^T and H(x) = -laplacian(S) = c . S(x) (c = 1 for node
terms, 2 for pairwise), the estimator solves

    phi_hat = Gamma_hat^{-1} H_hat,
    Gamma_hat = mean_i G(x_i),  H_hat = mean_i c . S(x_i)

with sandwich covariance cov(phi_hat) = Gamma^{-1} V Gamma^{-1} / n,
V = mean_i g_i g_i^T evaluated at phi_hat.  Per-edge significance is the
Wald chi^2 test on that pair's coefficient block.

Design notes: Gamma_hat is assembled per-node — each stat touches at
most two coordinates, so node l contributes a dense block over only the
O(d) stats involving l; total cost O(d^3 n) instead of the naive O(d^4 n).
All fits are pure jitted functions; the trial axis vmaps, so the paper's
serial bootstrap loops (``torus_graph_fit.py:49-58``) become one batched
program in :func:`bootstrap_partial_plv`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pair_index(d: int) -> np.ndarray:
    """(npairs, 2) array of node pairs j<k in lexicographic order."""
    return np.array([(j, k) for j in range(d) for k in range(j + 1, d)], dtype=np.int32)


class TGLayout(NamedTuple):
    """Static index layout of the phi vector for (d, sel_mode)."""

    d: int
    sel_mode: Tuple[bool, bool, bool]
    pairs: np.ndarray  # (npairs, 2)
    m: int  # total number of parameters
    marg_off: int  # offset of marginal block (or -1)
    diff_off: int
    sum_off: int


def layout(d: int, sel_mode=(False, True, False)) -> TGLayout:
    pairs = pair_index(d)
    npairs = pairs.shape[0]
    off = 0
    marg_off = diff_off = sum_off = -1
    if sel_mode[0]:
        marg_off = off
        off += 2 * d
    if sel_mode[1]:
        diff_off = off
        off += 2 * npairs
    if sel_mode[2]:
        sum_off = off
        off += 2 * npairs
    return TGLayout(d=d, sel_mode=tuple(sel_mode), pairs=pairs, m=off,
                    marg_off=marg_off, diff_off=diff_off, sum_off=sum_off)


def suff_stats(lay: TGLayout, X):
    """S(X): (m, n) sufficient statistics for X (d, n) in radians."""
    X = jnp.asarray(X)
    j = lay.pairs[:, 0]
    k = lay.pairs[:, 1]
    parts = []
    if lay.sel_mode[0]:
        parts.append(jnp.cos(X))
        parts.append(jnp.sin(X))
        # interleave cos_j, sin_j per node: stack as (2d, n) with cos block
        # then sin block is fine as long as we are consistent — we use
        # [cos(all nodes); sin(all nodes)] ordering.
        parts = [jnp.concatenate(parts, axis=0)]
    if lay.sel_mode[1]:
        delta = X[j] - X[k]
        parts.append(jnp.concatenate([jnp.cos(delta), jnp.sin(delta)], axis=0))
    if lay.sel_mode[2]:
        sig = X[j] + X[k]
        parts.append(jnp.concatenate([jnp.cos(sig), jnp.sin(sig)], axis=0))
    return jnp.concatenate(parts, axis=0)


def _c_vector(lay: TGLayout):
    """Laplacian scaling c: 1 for node stats, 2 for pairwise stats."""
    cs = []
    if lay.sel_mode[0]:
        cs.append(np.ones(2 * lay.d))
    if lay.sel_mode[1]:
        cs.append(2 * np.ones(2 * lay.pairs.shape[0]))
    if lay.sel_mode[2]:
        cs.append(2 * np.ones(2 * lay.pairs.shape[0]))
    return jnp.asarray(np.concatenate(cs))


def _node_stat_indices(lay: TGLayout, l: int) -> np.ndarray:
    """Indices of phi entries whose statistic involves coordinate l."""
    idx = []
    npairs = lay.pairs.shape[0]
    if lay.sel_mode[0]:
        idx += [lay.marg_off + l, lay.marg_off + lay.d + l]
    involved = np.nonzero((lay.pairs[:, 0] == l) | (lay.pairs[:, 1] == l))[0]
    if lay.sel_mode[1]:
        idx += list(lay.diff_off + involved) + list(lay.diff_off + npairs + involved)
    if lay.sel_mode[2]:
        idx += list(lay.sum_off + involved) + list(lay.sum_off + npairs + involved)
    return np.asarray(idx, dtype=np.int32)


def _node_derivs(lay: TGLayout, l: int, X):
    """dS/dx_l restricted to the stats involving l: (len(idx_l), n)."""
    X = jnp.asarray(X)
    involved = np.nonzero((lay.pairs[:, 0] == l) | (lay.pairs[:, 1] == l))[0]
    jj = lay.pairs[involved, 0]
    kk = lay.pairs[involved, 1]
    sign_l = jnp.asarray(np.where(jj == l, 1.0, -1.0))[:, None]  # +1 if l is j
    rows = []
    if lay.sel_mode[0]:
        rows.append(-jnp.sin(X[l])[None, :])
        rows.append(jnp.cos(X[l])[None, :])
    if lay.sel_mode[1]:
        delta = X[jj] - X[kk]
        # d cos(delta)/dx_l = -sin(delta)*sign_l ; d sin(delta)/dx_l = cos(delta)*sign_l
        rows.append(-jnp.sin(delta) * sign_l)
        rows.append(jnp.cos(delta) * sign_l)
    if lay.sel_mode[2]:
        sig = X[jj] + X[kk]
        rows.append(-jnp.sin(sig))
        rows.append(jnp.cos(sig))
    return jnp.concatenate(rows, axis=0)


def gamma_matrix(lay: TGLayout, X):
    """Gamma_hat = mean_i grad_S grad_S^T, assembled per node; (m, m)."""
    X = jnp.asarray(X)
    n = X.shape[1]
    G = jnp.zeros((lay.m, lay.m), X.dtype)
    for l in range(lay.d):
        idx = _node_stat_indices(lay, l)
        C = _node_derivs(lay, l, X)  # (len(idx), n)
        block = (C @ C.T) / n
        G = G.at[jnp.ix_(jnp.asarray(idx), jnp.asarray(idx))].add(block)
    return G


def score_vector(lay: TGLayout, X, phi):
    """Model score d/dx_l [phi^T S(x)] for each sample: (d, n)."""
    X = jnp.asarray(X)
    d, n = X.shape
    out = jnp.zeros((d, n), X.dtype)
    for l in range(lay.d):
        idx = jnp.asarray(_node_stat_indices(lay, l))
        C = _node_derivs(lay, l, X)
        out = out.at[l].set(jnp.einsum("m,mn->n", phi[idx], C))
    return out


class TorusGraphResult(NamedTuple):
    phi: jnp.ndarray  # (m,)
    phi_cov: jnp.ndarray  # (m, m) sandwich covariance of phi_hat
    pairs: np.ndarray  # (npairs, 2)
    pvals: jnp.ndarray  # (npairs,) per-edge Wald test p-values
    kappa: jnp.ndarray  # (npairs,) coupling magnitudes ||phi_pair||
    cond_coupling: jnp.ndarray  # (npairs,) partial PLV I1(kappa)/I0(kappa)
    graph: jnp.ndarray  # (npairs,) bool at alpha=0.05 Bonferroni


def _pair_blocks(lay: TGLayout):
    """(npairs, q) index array of each pair's phi entries (q = 2 or 4)."""
    npairs = lay.pairs.shape[0]
    cols = []
    if lay.sel_mode[1]:
        cols += [lay.diff_off + np.arange(npairs), lay.diff_off + npairs + np.arange(npairs)]
    if lay.sel_mode[2]:
        cols += [lay.sum_off + np.arange(npairs), lay.sum_off + npairs + np.arange(npairs)]
    return np.stack(cols, axis=1)  # (npairs, q)


def torus_graph_fit(X, sel_mode=(False, True, False), alpha=0.05) -> TorusGraphResult:
    """Score-matching fit of a torus graph to phases X (d, n) in radians.

    Mirrors the used surface of ``pyTG.torusGraphs``: coefficient vector,
    sandwich covariance, per-edge p-values, conditional coupling (partial
    PLV), Bonferroni graph.
    """
    X = jnp.asarray(X)
    if not (sel_mode[1] or sel_mode[2]):
        raise ValueError("need pairwise terms: sel_mode[1] or sel_mode[2]")
    d, n = X.shape
    lay = layout(d, sel_mode)

    S = suff_stats(lay, X)  # (m, n)
    c = _c_vector(lay)
    H = jnp.mean(c[:, None] * S, axis=1)
    Gamma = gamma_matrix(lay, X)
    # adaptive ridge: keeps the solve stable when channels are near-
    # deterministically coupled (collinear statistics -> singular Gamma)
    jitter = 1e-8 * jnp.mean(jnp.diag(Gamma)) * jnp.eye(lay.m, dtype=X.dtype)
    phi = jnp.linalg.solve(Gamma + jitter, H)

    # sandwich covariance: g_i = gradS_i score_i - c*S_i ; V = mean g g^T
    score = score_vector(lay, X, phi)  # (d, n)
    # gradS_i score_i accumulated per node (same restriction trick)
    Gphi = jnp.zeros((lay.m, n), X.dtype)
    for l in range(lay.d):
        idx = jnp.asarray(_node_stat_indices(lay, l))
        C = _node_derivs(lay, l, X)
        Gphi = Gphi.at[idx].add(C * score[l][None, :])
    g = Gphi - c[:, None] * S  # (m, n)
    V = (g @ g.T) / n
    Ginv = jnp.linalg.solve(Gamma + jitter, jnp.eye(lay.m, dtype=X.dtype))
    phi_cov = Ginv @ V @ Ginv.T / n

    # per-edge Wald tests
    blocks = _pair_blocks(lay)  # (npairs, q)
    q = blocks.shape[1]
    phi_b = phi[blocks]  # (npairs, q)
    cov_b = phi_cov[blocks[:, :, None], blocks[:, None, :]]  # (npairs, q, q)
    sol = jnp.linalg.solve(cov_b, phi_b[..., None])[..., 0]
    stat = jnp.einsum("pq,pq->p", phi_b, sol)
    pvals = jax.scipy.special.gammaincc(q / 2.0, jnp.maximum(stat, 0.0) / 2.0)

    # coupling magnitude & partial PLV (phase-difference concentration)
    kappa = jnp.linalg.norm(phi_b, axis=1)
    cond_coupling = jax.scipy.special.i1e(kappa) / jax.scipy.special.i0e(kappa)

    npairs = blocks.shape[0]
    graph = pvals < (alpha / npairs)
    return TorusGraphResult(
        phi=phi, phi_cov=phi_cov, pairs=lay.pairs, pvals=pvals,
        kappa=kappa, cond_coupling=cond_coupling, graph=graph,
    )


def torusGraphs(X, selMode=(False, True, False)):
    """pyTG-compatible call signature (``torus_graph_fit`` is the native API).

    Returns (graph, None, None, nodepairs, None, phi, phi_cov) with
    nodepairs = {'pVals', 'condCoupling', 'kappa', 'pairs'} — the surface the
    reference workloads consume (``torus_graph_fit.py:31-38``).
    """
    res = torus_graph_fit(np.asarray(X), sel_mode=tuple(selMode))
    nodepairs = {
        "pVals": np.asarray(res.pvals),
        "condCoupling": np.asarray(res.cond_coupling),
        "kappa": np.asarray(res.kappa),
        "pairs": res.pairs,
    }
    return (
        np.asarray(res.graph),
        None,
        None,
        nodepairs,
        None,
        np.asarray(res.phi),
        np.asarray(res.phi_cov),
    )


def bootstrap_partial_plv(
    X, nboot, key, sel_mode=(False, True, False), batch_size=4
):
    """Trial bootstrap of conditional coupling, vmapped in batches.

    Replaces the reference's serial loops (``torus_graph_fit.py:49-58``,
    ``neuropixels/fit_torus_graph.py:51-59``).  Returns (npairs, nboot).
    """
    X = jnp.asarray(X)
    d, n = X.shape

    @jax.jit
    def one(k):
        idx = jax.random.choice(k, n, (n,), replace=True)
        res = torus_graph_fit(X[:, idx], sel_mode=sel_mode)
        return res.cond_coupling

    batched = jax.jit(jax.vmap(one))
    keys = jax.random.split(key, nboot)
    out = []
    for i in range(0, nboot, batch_size):
        out.append(np.asarray(batched(keys[i : i + batch_size])))
    return np.concatenate(out, axis=0).T


def gibbs_sample(phi, d, n, seed=0, sel_mode=(False, True, False), burnin=200, thin=2):
    """Host-side Gibbs sampler from a torus graph (von Mises full
    conditionals) — generative utility for simulation studies and tests.
    Returns (d, n) angles in radians.
    """
    lay = layout(d, sel_mode)
    phi = np.asarray(phi)
    npairs = lay.pairs.shape[0]
    # unpack into dense coupling matrices
    eta_c = np.zeros(d)
    eta_s = np.zeros(d)
    a_c = np.zeros((d, d))  # cos-difference couplings (symmetric)
    a_s = np.zeros((d, d))  # sin-difference couplings (antisymmetric)
    b_c = np.zeros((d, d))  # cos-sum couplings (symmetric)
    b_s = np.zeros((d, d))  # sin-sum couplings (symmetric)
    if lay.sel_mode[0]:
        eta_c = phi[lay.marg_off : lay.marg_off + d]
        eta_s = phi[lay.marg_off + d : lay.marg_off + 2 * d]
    for p, (j, k) in enumerate(lay.pairs):
        if lay.sel_mode[1]:
            a_c[j, k] = a_c[k, j] = phi[lay.diff_off + p]
            a_s[j, k] = phi[lay.diff_off + npairs + p]
            a_s[k, j] = -phi[lay.diff_off + npairs + p]
        if lay.sel_mode[2]:
            b_c[j, k] = b_c[k, j] = phi[lay.sum_off + p]
            b_s[j, k] = b_s[k, j] = phi[lay.sum_off + npairs + p]

    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 2 * np.pi, size=d)
    out = np.empty((d, n))
    total = burnin + n * thin
    kept = 0
    for it in range(total):
        for j in range(d):
            cosx = np.cos(x)
            sinx = np.sin(x)
            # p(x_j | rest) ∝ exp(a cos x_j + b sin x_j)
            a = eta_c[j] + a_c[j] @ cosx - a_s[j] @ sinx + b_c[j] @ cosx + b_s[j] @ sinx
            bb = eta_s[j] + a_c[j] @ sinx + a_s[j] @ cosx - b_c[j] @ sinx + b_s[j] @ cosx
            # remove self terms (diagonals are zero by construction)
            kappa = np.hypot(a, bb)
            mu = np.arctan2(bb, a)
            x[j] = rng.vonmises(mu, kappa) % (2 * np.pi)
        if it >= burnin and (it - burnin) % thin == 0:
            out[:, kept] = x
            kept += 1
            if kept == n:
                break
    return out
