"""Priors over GPCSD hyperparameters.

Parity targets: ``GPCSDInvGammaPrior`` and ``GPCSDHalfNormalPrior`` in
``/root/reference/src/gpcsd/priors.py:14-51`` — including the *unnormalized*
log-densities (constant offsets dropped) and the InvGamma ``set_params``
heuristic that places the bulk of mass inside a user interval.  Keeping them
unnormalized is fine for MAP/NUTS; SMC model comparison must use
``log_normalizer`` (provided here) to stay consistent (SURVEY.md §5).

``lpdf`` is a pure jnp function of (possibly batched) values; the
reference's ``x <= 0 -> -inf`` branch becomes a ``jnp.where`` so it traces.
``sample`` takes an explicit PRNG key.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from scipy.special import gammaln as _gammaln

_NEG_INF = -jnp.inf


@dataclasses.dataclass(frozen=True)
class Prior:
    def lpdf(self, x):
        raise NotImplementedError

    def sample(self, key, shape=()):
        raise NotImplementedError

    def log_normalizer(self):
        """log of the dropped normalization constant (lpdf + this = true lpdf)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class InvGamma(Prior):
    """Inverse-gamma prior; unnormalized lpdf = -(alpha+1) log x - beta/x."""

    alpha: float = 1.0
    beta: float = 1.0

    def lpdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(float))
        val = -(self.alpha + 1.0) * jnp.log(jnp.where(x > 0, x, 1.0)) - self.beta / x
        return jnp.where(x > 0, val, _NEG_INF)

    def log_normalizer(self):
        return self.alpha * jnp.log(self.beta) - _gammaln(self.alpha)

    def sample(self, key, shape=()):
        # X ~ InvGamma(a, b)  <=>  X = b / Gamma(a, 1)
        g = jax.random.gamma(key, self.alpha, shape=shape)
        return self.beta / g

    @staticmethod
    def from_interval(l, u):
        """Reference ``set_params`` heuristic (``priors.py:30-32``):
        alpha = 2 + 9((l+u)/(u-l))^2, beta = (alpha-1)(l+u)/2.

        A degenerate interval (u <= l) would divide by zero and silently
        produce inf/nan hyperparameters, so it raises instead.
        """
        if not u > l:
            raise ValueError(
                f"InvGamma.from_interval needs u > l, got l={l!r}, u={u!r}"
            )
        alpha = 2.0 + 9.0 * ((l + u) / (u - l)) ** 2
        beta = 0.5 * (alpha - 1.0) * (l + u)
        return InvGamma(alpha=float(alpha), beta=float(beta))

    def __str__(self):
        return "InvGamma(%0.2f, %0.2f)" % (self.alpha, self.beta)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Prior):
    """Half-normal prior; unnormalized lpdf = -0.5 (x/sd)^2 for x > 0."""

    sd: float = 1.0

    def lpdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(float))
        return jnp.where(x > 0, -0.5 * jnp.square(x / self.sd), _NEG_INF)

    def log_normalizer(self):
        return 0.5 * jnp.log(2.0 / jnp.pi) - jnp.log(self.sd)

    def sample(self, key, shape=()):
        return jnp.abs(jax.random.normal(key, shape)) * self.sd

    def __str__(self):
        return "HalfNormal(%0.2f)" % (self.sd,)


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    """Normal prior (used e.g. for per-trial time-shift regularization,
    reference ``auditory_lfp/fit_mean_function.py:306-311``)."""

    mu: float = 0.0
    sd: float = 1.0

    def lpdf(self, x):
        x = jnp.asarray(x, dtype=jnp.result_type(float))
        return -0.5 * jnp.square((x - self.mu) / self.sd)

    def log_normalizer(self):
        return -0.5 * jnp.log(2.0 * jnp.pi) - jnp.log(self.sd)

    def sample(self, key, shape=()):
        return self.mu + jax.random.normal(key, shape) * self.sd

    def __str__(self):
        return "Normal(%0.2f, %0.2f)" % (self.mu, self.sd)
