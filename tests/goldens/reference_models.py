"""Models and recorded outputs of the executed-reference goldens.

``reference_goldens.npz`` + ``reference_scalars.json`` were produced by
executing the reference ``gpcsd`` package itself on CPU float64 (see
``generate.py``).  The builders here reproduce the exact configurations
those values were recorded at; ``tests/test_reference_golden.py`` pins the
package to them on CPU, and ``chip_smoke.py`` recomputes the model values
on the GPU.
"""

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = np.load(os.path.join(HERE, "reference_goldens.npz"))
with open(os.path.join(HERE, "reference_scalars.json")) as f:
    SCAL = json.load(f)

#: tolerances against the recorded reference values
LOGLIK_RTOL = 1e-8
# we add the 1e-8 Ks jitter at predict time where the reference omits it
# (SURVEY.md §5 quirk), which shifts near-zero predictions by ~1e-9 absolute
PREDICT_RTOL, PREDICT_ATOL = 1e-6, 1e-8


def spatial_cov_1d():
    from gpcsd_tpu.models.covariances import GPCSD1DSpatialCovSE

    xs = np.linspace(0.0, 700.0, 8)[:, None]
    scov = GPCSD1DSpatialCovSE(xs, a=-200.0, b=900.0, ngl=24)
    scov.params["ell"]["value"] = 200.0
    return scov


def temporal_covs():
    from gpcsd_tpu.models.covariances import (
        GPCSDTemporalCovMatern,
        GPCSDTemporalCovSE,
    )

    ts = np.arange(12.0)[:, None]
    tse = GPCSDTemporalCovSE(ts)
    tse.params["ell"]["value"] = 7.0
    tse.params["sigma2"]["value"] = 1.1
    tma = GPCSDTemporalCovMatern(ts)
    tma.params["ell"]["value"] = 2.5
    tma.params["sigma2"]["value"] = 0.6
    return tse, tma


def model_1d(het=False):
    import gpcsd_tpu as g

    xs = np.linspace(0.0, 700.0, 8)[:, None]
    ts = np.arange(12.0)[:, None]
    tse, tma = temporal_covs()
    kw = {}
    if het:
        kw["sig2n_prior"] = [g.HalfNormal(0.1) for _ in range(8)]
    m = g.GPCSD1D(GOLD["m1_Y"], xs, ts, a=-200.0, b=900.0, ngl=24,
                  spatial_cov=spatial_cov_1d(), temporal_cov_list=[tse, tma],
                  **kw)
    m.R["value"] = 150.0
    m.sig2n["value"] = (
        GOLD["ceD_sig2n_vec"] if het else 0.05
    )
    return m


def predict_1d(m):
    """Run the golden 1D prediction in place (sets ``m.csd_pred`` etc.)."""
    zq = np.linspace(50.0, 650.0, 5)[:, None]
    ts = np.arange(12.0)[:, None]
    m.predict(zq, ts, type="both")


#: golden key -> model attribute holding the 1D prediction
PREDICT_KEYS = {
    "m1_csd_pred": lambda m: m.csd_pred,
    "m1_lfp_pred": lambda m: m.lfp_pred,
    "m1_csd_pred_c0": lambda m: m.csd_pred_list[0],
    "m1_csd_pred_c1": lambda m: m.csd_pred_list[1],
}


def model_2d():
    import gpcsd_tpu as g

    t2 = np.arange(9.0)[:, None]
    m = g.GPCSD2D(GOLD["m2_Y"], GOLD["m2_x"], t2, a1=0.0, b1=64.0,
                  a2=-50.0, b2=350.0, ngl1=8, ngl2=12, eps=1.0)
    m.R["value"] = 80.0
    m.spatial_cov.params["ell1"]["value"] = 30.0
    m.spatial_cov.params["ell2"]["value"] = 100.0
    m.temporal_cov_list[0].params["ell"]["value"] = 4.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 1.5
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.1
    return m
