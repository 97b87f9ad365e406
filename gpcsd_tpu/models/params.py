"""Named-parameter DSL: supports, bijectors, packing.

This is the model-DSL substrate (SURVEY.md §2d): every inference engine in
:mod:`gpcsd_tpu.infer` (MAP / NUTS / ADVI / SMC) operates on a flat
unconstrained vector; :class:`ParamSet` maps it to/from named, constrained
hyperparameters.

The bijector is the reference's log transform including its ``/100`` scaling
convention for R and spatial lengthscales (``gpcsd1d.py:138-139,161-174``):

    constrained theta = exp(u) * scale,  u unconstrained

Box bounds (reference L-BFGS-B bounds, ``gpcsd1d.py:137-151``) live in
u-space as ``[log(lo/scale), log(hi/scale)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .priors import Prior


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One named (possibly vector) positive parameter."""

    prior: Tuple[Prior, ...] | Prior
    lo: np.ndarray  # broadcastable to shape
    hi: np.ndarray
    scale: float = 1.0
    size: int = 1  # number of scalar components

    @property
    def priors(self) -> Tuple[Prior, ...]:
        if isinstance(self.prior, tuple):
            return self.prior
        return (self.prior,) * self.size


class ParamSet:
    """Ordered collection of :class:`ParamSpec` with pack/unpack utilities."""

    def __init__(self, specs: Dict[str, ParamSpec]):
        self.specs = dict(specs)
        self.names = list(specs.keys())
        self._offsets = {}
        off = 0
        for name in self.names:
            self._offsets[name] = (off, off + specs[name].size)
            off += specs[name].size
        self.dim = off

    def names_flat(self):
        """Per-scalar-component names in packing order (vector params expand
        to ``name[i]``)."""
        out = []
        for name in self.names:
            s = self.specs[name]
            if s.size == 1:
                out.append(name)
            else:
                out.extend(f"{name}[{i}]" for i in range(s.size))
        return out

    # -- packing ------------------------------------------------------------

    def pack(self, theta: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        """Named constrained values -> flat unconstrained vector."""
        parts = []
        for name in self.names:
            s = self.specs[name]
            v = jnp.asarray(theta[name], dtype=jnp.result_type(float)).reshape(-1)
            parts.append(jnp.log(v / s.scale))
        return jnp.concatenate(parts)

    #: Positive floor on constrained values.  In a float32 range
    #: ``exp(u)`` for u below ~-87 flushes to EXACTLY 0 while float64 keeps
    #: a tiny positive number — and a zero turns InvGamma/log-prior terms
    #: into -inf.  The floor sits just above the f32 flush threshold; any
    #: value near it is astronomically improbable under every prior, so
    #: this only converts a dtype-dependent -inf cliff into the same
    #: astronomically-negative-but-finite density float64 reports.
    VALUE_FLOOR = 1e-35

    def unpack(self, u: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """Flat unconstrained vector -> named constrained values."""
        out = {}
        for name in self.names:
            lo, hi = self._offsets[name]
            s = self.specs[name]
            v = jnp.maximum(jnp.exp(u[..., lo:hi]) * s.scale, self.VALUE_FLOOR)
            out[name] = v[..., 0] if s.size == 1 else v
        return out

    # -- densities ----------------------------------------------------------

    def log_prior(self, theta: Dict[str, jnp.ndarray]):
        """Sum of (unnormalized) prior lpdfs over all components."""
        total = 0.0
        for name in self.names:
            s = self.specs[name]
            v = jnp.atleast_1d(jnp.asarray(theta[name]))
            for i, p in enumerate(s.priors):
                total = total + p.lpdf(v[..., i] if s.size > 1 else v[..., 0])
        return total

    def log_det_jacobian(self, u: jnp.ndarray):
        """log |d theta / d u| for the exp bijector = sum(u) + sum(log scale)."""
        logscale = sum(
            np.log(self.specs[n].scale) * self.specs[n].size for n in self.names
        )
        return jnp.sum(u, axis=-1) + logscale

    # -- bounds & sampling ---------------------------------------------------

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) box bounds in unconstrained space, each (dim,)."""
        lo = np.empty(self.dim)
        hi = np.empty(self.dim)
        for name in self.names:
            o0, o1 = self._offsets[name]
            s = self.specs[name]
            lo[o0:o1] = np.log(np.broadcast_to(s.lo, (s.size,)) / s.scale)
            hi[o0:o1] = np.log(np.broadcast_to(s.hi, (s.size,)) / s.scale)
        return lo, hi

    def sample(self, key, fixed: Dict[str, jnp.ndarray] | None = None):
        """Draw constrained values from the priors (restart initialization,
        mirroring ``gpcsd1d.py:194-208``); ``fixed`` entries override."""
        fixed = fixed or {}
        out = {}
        keys = jax.random.split(key, self.dim)
        k = 0
        for name in self.names:
            s = self.specs[name]
            if name in fixed:
                out[name] = jnp.asarray(fixed[name])
                k += s.size
                continue
            vals = []
            for p in s.priors:
                vals.append(p.sample(keys[k]))
                k += 1
            v = jnp.stack([jnp.asarray(x) for x in vals])
            out[name] = v[0] if s.size == 1 else v
        return out

    def clip_to_bounds(self, u: jnp.ndarray):
        lo, hi = self.bounds()
        return jnp.clip(u, jnp.asarray(lo), jnp.asarray(hi))
