"""CSD -> LFP forward operators (1D and 2D), fully vectorized.

Physics parity targets (formulas, not code):
- 1D weight ``b(r, R) = sqrt((r/R)^2 + 1) - |r/R|``
  (reference ``/root/reference/src/gpcsd/forward_models.py:9-17``).
- 2D weight ``b(w, R, eps) = log(R+eps+sqrt((R+eps)^2+w^2)) -
  log(eps+sqrt(eps^2+w^2))`` (reference ``forward_models.py:42-54``).
- Data-space forward models integrate the weight against a CSD field with the
  trapezoid rule (reference ``forward_models.py:20-39`` and ``:57-81``, which
  loop over every (z, t) pair in Python).

Redesign: the quadrature is a *linear operator* — build the dense
(nz, nx) trapezoid-weighted matrix once and apply it as a single matmul over
all time points (and any leading batch axes), so one GEMM does the integral.
"""

from __future__ import annotations

import jax.numpy as jnp


def b_fwd_1d(r, R):
    """1D forward-model weight function; elementwise in ``r``."""
    u = r / R
    return jnp.sqrt(jnp.square(u) + 1.0) - jnp.abs(u)


def b_fwd_2d(w, R, eps):
    """2D forward-model weight as a function of planar distance ``w``."""
    Re = R + eps
    return jnp.log(Re + jnp.sqrt(Re * Re + w * w)) - jnp.log(
        eps + jnp.sqrt(eps * eps + w * w)
    )


def trapezoid_weights(x):
    """Composite trapezoid-rule weights for (possibly nonuniform) nodes x."""
    x = jnp.asarray(x).reshape(-1)
    d = jnp.diff(x)
    left = jnp.concatenate([d[:1] * 0.5, d * 0.5])
    right = jnp.concatenate([d * 0.5, d[-1:] * 0.5])
    # interior points get (dx_prev + dx_next)/2; endpoints get half intervals
    w = jnp.zeros_like(x).at[:-1].add(d * 0.5).at[1:].add(d * 0.5)
    del left, right
    return w


def fwd_operator_1d(x, z, R, varsigma=1.0):
    """Dense (nz, nx) linear operator mapping CSD at nodes x to LFP at z.

    Rows are ``R/(2*varsigma) * trapz_w * b((z_i - x_j)/R)``, matching the
    per-element integral of the reference ``fwd_model_1d``.
    """
    x = jnp.asarray(x).reshape(-1)
    z = jnp.asarray(z).reshape(-1)
    W = b_fwd_1d(z[:, None] - x[None, :], R) * trapezoid_weights(x)[None, :]
    return (R / (2.0 * varsigma)) * W


def fwd_model_1d(arr, x, z, R, varsigma=1.0):
    """Apply the 1D forward model to a CSD array.

    :param arr: (..., nx, nt) CSD sampled at locations ``x``
    :return: (..., nz, nt) LFP at locations ``z``
    """
    op = fwd_operator_1d(x, z, R, varsigma)
    return jnp.einsum("zx,...xt->...zt", op, jnp.asarray(arr))


def fwd_operator_2d(x1, x2, z, R, eps):
    """Dense (nz, nx1, nx2) operator for the 2D forward model.

    ``z`` is an (nz, 2) list of output locations; the CSD lives on the tensor
    grid x1 (x) x2.  Matches the double-trapezoid integral of the reference
    ``fwd_model_2d`` (whose ``1/(4*pi*varsigma)`` gain is intentionally
    omitted there, ``forward_models.py:81`` — we match that behavior).
    """
    x1 = jnp.asarray(x1).reshape(-1)
    x2 = jnp.asarray(x2).reshape(-1)
    z = jnp.asarray(z)
    d1 = z[:, 0][:, None] - x1[None, :]  # (nz, nx1)
    d2 = z[:, 1][:, None] - x2[None, :]  # (nz, nx2)
    w = jnp.sqrt(jnp.square(d1)[:, :, None] + jnp.square(d2)[:, None, :])
    wt = b_fwd_2d(w, R, eps)
    tw = trapezoid_weights(x1)[None, :, None] * trapezoid_weights(x2)[None, None, :]
    return wt * tw


def fwd_model_2d(arr, x1, x2, z, R, eps, varsigma=1.0):
    """Apply the 2D forward model.

    :param arr: (..., nx1, nx2, nt) CSD on the grid
    :return: (..., nz, nt) LFP at the (nz, 2) locations ``z``
    """
    del varsigma  # reference leaves the 1/(4*pi*varsigma) gain commented out
    op = fwd_operator_2d(x1, x2, z, R, eps)
    return jnp.einsum("zjk,...jkt->...zt", op, jnp.asarray(arr))
