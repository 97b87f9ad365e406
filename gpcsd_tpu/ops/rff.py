"""Random Fourier features for squared-exponential priors.

Scalable pathwise (Matheron) posterior sampling needs joint *prior* draws of
the CSD field on (prediction points) ∪ (quadrature nodes).  The exact route
Choleskys the (nz + ngl)^2 union kernel — fine at reference sizes, but the
Neuropixels 2D configuration has ngl1*ngl2 = 3600 quadrature nodes and the
SE Gram there is numerically rank-deficient long before it is large.  The
standard fix (Wilson et al. 2020, "Efficiently sampling functions from GP
posteriors") replaces the prior draw with a random Fourier feature
expansion — the posterior correction stays exact, so the only error is the
O(1/sqrt(M)) prior kernel approximation:

    csd(x) ~= sqrt(2/M) * sum_m cos(w_m^T x + b_m) z_m,
    w_m ~ N(0, diag(1/ell^2)),  b_m ~ U(0, 2pi)   (SE spectral measure)

Everything is one (npoints, M) feature matrix and batched
matmuls — no large Cholesky, no gather.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def se_rff_features(key, points, ells, n_features: int):
    """Feature matrix Phi with Phi @ Phi^T ~= SE correlation kernel.

    :param points: (n,) / (n, 1) for 1D or (n, d) locations
    :param ells: scalar length-scale or per-dimension (d,) length-scales
    :param n_features: number of random features M
    :return: (n, M) feature matrix (unit prior variance)
    """
    pts = jnp.atleast_2d(jnp.asarray(points, jnp.result_type(float)))
    if pts.shape[0] == 1 and np.ndim(points) == 1:
        pts = pts.T
    n, d = pts.shape
    ells = jnp.broadcast_to(jnp.asarray(ells, pts.dtype), (d,))
    kw, kb = jax.random.split(key)
    w = jax.random.normal(kw, (d, n_features), pts.dtype) / ells[:, None]
    b = jax.random.uniform(kb, (n_features,), pts.dtype, 0.0, 2.0 * jnp.pi)
    proj = pts @ w + b[None, :]
    return jnp.sqrt(2.0 / n_features) * jnp.cos(proj)
