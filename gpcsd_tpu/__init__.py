"""gpcsd-tpu: a JAX probabilistic inference engine for GPCSD.

A from-scratch JAX/XLA framework with the capabilities of the
reference ``gpcsd`` package (Klein et al. 2021, arXiv:2104.10070): Gaussian
process current-source-density estimation from LFP recordings, with a
Kronecker-structured marginal likelihood, quadrature forward-model
covariances, MAP / NUTS / ADVI / SMC hyperparameter inference, and
multi-device scaling via jax.sharding.
"""

from . import config  # noqa: F401  (sets x64 policy at import)
from .models.gpcsd1d import GPCSD1D
from .models.gpcsd2d import GPCSD2D
from .models.trad import predictcsd_trad_1d, predictcsd_trad_2d
from .models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCovSE,
    GPCSDTemporalCovMatern,
)
from .models.priors import InvGamma, HalfNormal, Normal
from .models.torus_graph import torus_graph_fit, torusGraphs
from .models.shifts import estimate_shifts
from . import signal  # noqa: F401

# Reference-compatible aliases (gpcsd.priors.GPCSD*Prior)
GPCSDInvGammaPrior = InvGamma
GPCSDHalfNormalPrior = HalfNormal

__all__ = [
    "GPCSD1D",
    "GPCSD2D",
    "predictcsd_trad_1d",
    "predictcsd_trad_2d",
    "GPCSD1DSpatialCovSE",
    "GPCSD2DSpatialCovSE",
    "GPCSDTemporalCovSE",
    "GPCSDTemporalCovMatern",
    "InvGamma",
    "HalfNormal",
    "Normal",
    "GPCSDInvGammaPrior",
    "GPCSDHalfNormalPrior",
    "torus_graph_fit",
    "torusGraphs",
    "estimate_shifts",
    "signal",
]

__version__ = "0.1.0"
