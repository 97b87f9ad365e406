"""Quadrature spatial covariances: the forward operator folded into the kernel.

The GPCSD trick (reference ``/root/reference/src/gpcsd/covariances.py``):
apply the CSD->LFP integral operator analytically to the spatial kernel via a
fixed Gauss-Legendre rule.  With ``A = gl_w * b(x - gl_x, R)`` the LFP-LFP
and LFP-CSD spatial covariances are

    Kphi(x, xp)  = A(x) @ K(gl, gl) @ A(xp)^T      (compKphi_1d, :74-96)
    Kphig(x, z)  = A(x) @ K(gl, z)                  (compKphig_1d, :58-72)

and their 2D analogues on a tensor-product rule (compKphi_2d :204-232,
compKphig_2d :188-202).  Everything here is a chain of elementwise ops into
matmuls — exactly what XLA fuses and hands to the matrix units.  The quadrature rule and
pairwise deltas are static geometry, passed in as arrays so the functions stay
pure/jittable; the model layer precomputes them once.
"""

from __future__ import annotations

import jax.numpy as jnp

from .forward import b_fwd_1d, b_fwd_2d
from .kernels import se, se_2d


def quad_weights_1d(x, gl_x, gl_w, R):
    """A(x) = gl_w * b(x - gl_x, R); shape (nx, ngl)."""
    x = jnp.asarray(x).reshape(-1)
    gl_x = jnp.asarray(gl_x).reshape(-1)
    delta = x[:, None] - gl_x[None, :]
    return jnp.asarray(gl_w).reshape(1, -1) * b_fwd_1d(delta, R)


def kphi_1d(x, gl_x, gl_w, ell, R, xp=None):
    """LFP-LFP spatial covariance (nx, nxp); forward model on both sides."""
    A = quad_weights_1d(x, gl_x, gl_w, R)
    Ap = A if xp is None else quad_weights_1d(xp, gl_x, gl_w, R)
    Kgl = se(gl_x, gl_x, ell)
    return A @ Kgl @ Ap.T


def kphig_1d(x, z, gl_x, gl_w, ell, R):
    """LFP-CSD spatial cross-covariance (nx, nz); forward model on x only."""
    A = quad_weights_1d(x, gl_x, gl_w, R)
    return A @ se(gl_x, z, ell)


def quad_weights_2d(delta_w, gl_w, R, eps):
    """A = gl_w * b(w, R, eps) from precomputed planar distances.

    :param delta_w: (nx, ngl) distances ||x_i - gl_j|| (static geometry)
    :param gl_w: (ngl,) product quadrature weights
    """
    return jnp.asarray(gl_w).reshape(1, -1) * b_fwd_2d(delta_w, R, eps)


def pairwise_w(x, y):
    """Planar distances between (n, 2) and (m, 2) point lists; (n, m)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    d1 = x[:, 0][:, None] - y[:, 0][None, :]
    d2 = x[:, 1][:, None] - y[:, 1][None, :]
    return jnp.sqrt(jnp.square(d1) + jnp.square(d2))


def kphi_2d(delta_w, gl_xy, gl_w, ell1, ell2, R, eps, delta_w_p=None):
    """2D LFP-LFP spatial covariance (nx, nxp).

    :param delta_w: (nx, ngl) distances from LFP sites to quadrature nodes
    :param gl_xy: (ngl, 2) quadrature node grid
    :param delta_w_p: optional (nxp, ngl) distances for the second side
    """
    A = quad_weights_2d(delta_w, gl_w, R, eps)
    Ap = A if delta_w_p is None else quad_weights_2d(delta_w_p, gl_w, R, eps)
    Kgl = se_2d(gl_xy, gl_xy, ell1, ell2)
    return A @ Kgl @ Ap.T


def kphig_2d(delta_w, gl_xy, z, gl_w, ell1, ell2, R, eps):
    """2D LFP-CSD cross-covariance (nx, nz) for CSD locations z (nz, 2)."""
    A = quad_weights_2d(delta_w, gl_w, R, eps)
    return A @ se_2d(gl_xy, z, ell1, ell2)
