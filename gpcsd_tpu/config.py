"""Global numeric policy for gpcsd-tpu.

The reference implementation (``/root/reference/src/gpcsd``) runs everything in
float64; float64 is load-bearing there because the Gauss-Legendre Gram matrix
at ngl=100 is ill-conditioned (see SURVEY.md §5 "Jitter").  Every backend
here runs the same float64 path by default (the CPU and the GPU both have
native float64 and LAPACK / cuSOLVER eigensolvers).  Two knobs remain for
explicit experiments:

- ``factor_dtype``: dtype for covariance construction, eigendecompositions and
  Cholesky factors (small matrices: nx<=128, nt<=2500).  ``float32`` selects
  the mixed-precision factor path (``kronlik.eigh_mixed``).
- ``compute_dtype``: dtype for the large batched contractions (trial
  quad-forms, posterior matvecs).

x64 is enabled at import time: correctness of the marginal likelihood
(log-determinant of D with sig2n as small as 1e-8, reference
``gpcsd1d.py:117-123``) is the default contract.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)

#: Root of the checkout that holds this package.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str | None:
    """Directory of JAX's persistent compilation cache, or None for no cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, wins (JAX reads it itself).
    Otherwise accelerator runs cache under ``<checkout>/.jax_cache`` — a
    fixed path, since the path is part of the cache key.  CPU-only runs keep
    no cache: XLA:CPU entries are specific to the host's detected feature
    set and can SIGILL when it drifts.
    """
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    if environ.get("JAX_PLATFORMS", "") == "cpu":
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):  # else JAX reads it
    _cache_dir = compile_cache_dir()
    if _cache_dir:
        jax.config.update("jax_compilation_cache_dir", _cache_dir)

#: Diagonal jitter added to spatial covariances, matching the reference
#: (``gpcsd1d.py:17`` and ``gpcsd2d.py:16``).
JITTER_1D = 1e-8
JITTER_2D = 1e-7


@dataclasses.dataclass
class Policy:
    #: dtype for covariance construction, eigendecompositions, D.  ``None``
    #: means float64.
    factor_dtype: jnp.dtype | None = None
    #: dtype for the large batched trial contractions.  ``None`` means
    #: float64.
    compute_dtype: jnp.dtype | None = None

    def resolve_compute_dtype(self):
        return jnp.float64 if self.compute_dtype is None else self.compute_dtype

    #: Mixed path only: solve the PRECONDITIONED temporal congruence with
    #: the identity-start fixed-budget refinement (``_eigh_mixed_ident``)
    #: instead of an f32-eigh start + fixed refinement.  The congruence to
    #: a trajectory-threaded (or MAP-centered, posterior-local) basis is
    #: already near-diagonal, so the f32 eigh start is redundant work.
    temporal_identity_start: bool = True
    #: Mixed path only: solve the spatial eigh as a near-diagonal
    #: congruence to a MAP-centered basis.  Off by default: the exact
    #: small-n eigh is bias-free everywhere, while the congruence
    #: refinement under-diagonalizes far from its center unless it runs
    #: many convergence-gated sweeps.
    spatial_precondition: bool = False

    def resolve_factor_dtype(self):
        return jnp.float64 if self.factor_dtype is None else self.factor_dtype


_policy = Policy()


def get_policy() -> Policy:
    return _policy


def set_policy(
    factor_dtype=None,
    compute_dtype=None,
    temporal_identity_start=None,
    spatial_precondition=None,
) -> Policy:
    """Override the numeric policy (e.g. the float32 mixed factor path)."""
    global _policy
    _policy = Policy(
        factor_dtype=jnp.dtype(factor_dtype) if factor_dtype else _policy.factor_dtype,
        compute_dtype=jnp.dtype(compute_dtype) if compute_dtype else _policy.compute_dtype,
        temporal_identity_start=(
            _policy.temporal_identity_start
            if temporal_identity_start is None
            else bool(temporal_identity_start)
        ),
        spatial_precondition=(
            _policy.spatial_precondition
            if spatial_precondition is None
            else bool(spatial_precondition)
        ),
    )
    return _policy
