"""Value-for-value parity against the REFERENCE IMPLEMENTATION'S OUTPUTS.

``tests/goldens/reference_goldens.npz`` + ``reference_scalars.json`` were
produced by executing ``/root/reference/src/gpcsd`` itself on CPU float64
(see ``tests/goldens/generate.py``).  These tests pin our implementations
to those recorded values — loglik, predict, fit bounds, prior heuristics,
and every kernel/utility — closing the gap between "agrees with an
independent dense oracle" and "agrees with the reference's execution".

Everything here is CPU float64 (conftest forces the CPU backend), so the
tolerance is numerical-roundoff tight.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens"))
import reference_models as rm  # noqa: E402

GOLD, SCAL = rm.GOLD, rm.SCAL
RTOL = rm.LOGLIK_RTOL


def close(ours, key, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(
        np.asarray(ours, dtype=np.float64), GOLD[key], rtol=rtol, atol=atol,
        err_msg=key,
    )


class TestUtilities:
    def test_mykron(self):
        from gpcsd_tpu.utility_functions import mykron

        close(mykron(GOLD["mykron_A"], GOLD["mykron_B"]), "mykron")

    def test_normalize(self):
        from gpcsd_tpu.utility_functions import normalize

        close(normalize(GOLD["normalize_in"]), "normalize")

    def test_expand_reduce_grid(self):
        from gpcsd_tpu.utility_functions import expand_grid, reduce_grid

        eg = expand_grid(np.array([0.0, 1.0, 2.0]), np.array([10.0, 20.0]))
        close(np.asarray(eg), "expand_grid")
        r1, r2 = reduce_grid(GOLD["expand_grid"])
        close(r1, "reduce_grid_1")
        close(r2, "reduce_grid_2")

    def test_comp_eig_D(self):
        """Flat Dvec parity, scalar and heteroscedastic sig2n (the latter
        pins the reference's Ks-eigenbasis approximation, SURVEY.md §5)."""
        from gpcsd_tpu.utility_functions import comp_eig_D

        _, _, d_hom = comp_eig_D(GOLD["ceD_Ks"], GOLD["ceD_Kt"], 0.05)
        close(d_hom, "ceD_D_hom")
        _, _, d_het = comp_eig_D(
            GOLD["ceD_Ks"], GOLD["ceD_Kt"], GOLD["ceD_sig2n_vec"]
        )
        close(d_het, "ceD_D_het")

    def test_comp_eig_D_factor_identity(self):
        """The factors must reproduce the same covariance the reference's
        do: (Qs kron Qt) diag(D) (Qs kron Qt)^T = Ks kron Kt + sig2n I."""
        from gpcsd_tpu.utility_functions import comp_eig_D, mykron

        Ks, Kt = GOLD["ceD_Ks"], GOLD["ceD_Kt"]
        Qs, Qt, D = comp_eig_D(Ks, Kt, 0.05)
        Q = np.asarray(mykron(np.asarray(Qs), np.asarray(Qt)))
        lhs = (Q * np.asarray(D)[None, :]) @ Q.T
        rhs = np.kron(Ks, Kt) + 0.05 * np.eye(Ks.shape[0] * Kt.shape[0])
        np.testing.assert_allclose(lhs, rhs, rtol=1e-8, atol=1e-10)


class TestForwardModels:
    def test_b_fwd_1d(self):
        from gpcsd_tpu.ops.forward import b_fwd_1d

        close(b_fwd_1d(GOLD["b_fwd_1d_in"], 150.0), "b_fwd_1d")

    def test_b_fwd_2d(self):
        from gpcsd_tpu.ops.forward import b_fwd_2d

        w = np.sqrt(GOLD["b_fwd_2d_d1"] ** 2 + GOLD["b_fwd_2d_d2"] ** 2)
        close(b_fwd_2d(w, 80.0, 1.0), "b_fwd_2d")

    def test_fwd_model_1d(self):
        from gpcsd_tpu.ops.forward import fwd_model_1d

        z6 = np.linspace(0.0, 700.0, 6)
        xs = np.linspace(0.0, 700.0, 8)
        close(fwd_model_1d(GOLD["fwd1d_csd"], z6, xs, 150.0), "fwd1d")

    def test_fwd_model_2d(self):
        from gpcsd_tpu.ops.forward import fwd_model_2d

        z1 = GOLD["fwd2d_z1"].reshape(-1)
        z2 = GOLD["fwd2d_z2"].reshape(-1)
        out = fwd_model_2d(GOLD["fwd2d_csd"], z1, z2, GOLD["fwd2d_x"],
                           80.0, 1.0)
        close(out, "fwd2d")

    def test_trad_csd_1d(self):
        from gpcsd_tpu.predict_csd import predictcsd_trad_1d

        close(predictcsd_trad_1d(GOLD["trad_in"]), "trad1d")


class TestPriors:
    def test_invgamma_heuristic(self):
        from gpcsd_tpu.models.priors import InvGamma

        for (l, u), (alpha, beta) in zip(
            GOLD["invgamma_pairs"], GOLD["invgamma_alpha_beta"]
        ):
            p = InvGamma.from_interval(l, u)
            assert np.isclose(p.alpha, alpha, rtol=RTOL), (l, u)
            assert np.isclose(p.beta, beta, rtol=RTOL), (l, u)

    def test_invgamma_lpdf(self):
        from gpcsd_tpu.models.priors import InvGamma

        p = InvGamma.from_interval(30.0, 100.0)
        ours = [float(p.lpdf(v)) for v in GOLD["invgamma_lpdf_pts"]]
        close(ours, "invgamma_lpdf")

    def test_halfnormal_lpdf(self):
        from gpcsd_tpu.models.priors import HalfNormal

        p = HalfNormal(SCAL["halfnormal_sd"])
        ours = [float(p.lpdf(v)) for v in np.array([0.01, 0.1, 0.3])]
        close(ours, "halfnormal_lpdf")


_spatial_cov_1d = rm.spatial_cov_1d
_temporal_covs = rm.temporal_covs


class TestCovariances:
    def test_spatial_1d(self):
        scov = _spatial_cov_1d()
        close(scov.gl_x, "spat1d_gl_x")
        close(scov.gl_w, "spat1d_gl_w")
        close(scov.compute_Ks(), "spat1d_Ks")
        close(scov.compKphi_1d(150.0), "spat1d_Kphi")
        zq = np.linspace(50.0, 650.0, 5)[:, None]
        close(scov.compKphi_1d(150.0, xp=zq), "spat1d_Kphi_xp")
        close(scov.compKphig_1d(zq, 150.0), "spat1d_Kphig")
        assert np.isclose(scov.params["ell"]["min"], SCAL["spat1d_ell_min"])
        assert np.isclose(scov.params["ell"]["max"], SCAL["spat1d_ell_max"])
        pr = scov.params["ell"]["prior"]
        assert np.isclose(pr.alpha, SCAL["spat1d_ell_prior_alpha"])
        assert np.isclose(pr.beta, SCAL["spat1d_ell_prior_beta"])

    def test_temporal(self):
        tse, tma = _temporal_covs()
        tstar = np.linspace(0.0, 11.0, 7)[:, None]
        close(tse.compute_Kt(), "tempSE_Kt")
        close(tse.compute_Kt(tstar), "tempSE_Kt_star")
        close(tma.compute_Kt(), "tempMa_Kt")
        close(tma.compute_Kt(tstar), "tempMa_Kt_star")
        assert np.isclose(tse.params["ell"]["min"], SCAL["tempSE_ell_min"])
        assert np.isclose(tse.params["ell"]["max"], SCAL["tempSE_ell_max"])
        pr = tse.params["ell"]["prior"]
        assert np.isclose(pr.alpha, SCAL["tempSE_ell_prior_alpha"])
        assert np.isclose(pr.beta, SCAL["tempSE_ell_prior_beta"])
        assert np.isclose(tse.params["sigma2"]["min"], SCAL["tempSE_sigma2_min"])
        assert tse.params["sigma2"]["max"] == SCAL["tempSE_sigma2_max"]


_model_1d = rm.model_1d


class TestGPCSD1DGolden:
    def test_loglik_hom(self):
        m = _model_1d()
        assert np.isclose(float(m.loglik()), SCAL["m1_loglik_hom"], rtol=RTOL)

    def test_loglik_het(self):
        m = _model_1d(het=True)
        assert np.isclose(float(m.loglik()), SCAL["m1_loglik_het"], rtol=RTOL)

    def test_fit_bounds_and_prior(self):
        m = _model_1d()
        assert np.isclose(m.R["min"], SCAL["m1_R_min"])
        assert np.isclose(m.R["max"], SCAL["m1_R_max"])
        assert np.isclose(m.R["prior"].alpha, SCAL["m1_R_prior_alpha"])
        assert np.isclose(m.R["prior"].beta, SCAL["m1_R_prior_beta"])
        assert np.isclose(m.sig2n["min"], SCAL["m1_sig2n_min"])
        assert np.isclose(m.sig2n["max"], SCAL["m1_sig2n_max"])

    def test_predict(self):
        m = _model_1d()
        rm.predict_1d(m)
        # atol at the jitter scale (see reference_models.PREDICT_ATOL)
        for key, get in rm.PREDICT_KEYS.items():
            close(get(m), key, rtol=rm.PREDICT_RTOL, atol=rm.PREDICT_ATOL)


class TestGPCSD2DGolden:
    def _model(self):
        return rm.model_2d()

    def test_loglik(self):
        m = self._model()
        assert np.isclose(float(m.loglik()), SCAL["m2_loglik"], rtol=RTOL)

    def test_bounds_and_spatial_kernels(self):
        m = self._model()
        assert np.isclose(m.R["prior"].alpha, SCAL["m2_R_prior_alpha"])
        assert np.isclose(m.R["prior"].beta, SCAL["m2_R_prior_beta"])
        sp = m.spatial_cov.params
        assert np.isclose(sp["ell1"]["min"], SCAL["m2_ell1_min"])
        assert np.isclose(sp["ell1"]["max"], SCAL["m2_ell1_max"])
        assert np.isclose(sp["ell2"]["min"], SCAL["m2_ell2_min"])
        assert np.isclose(sp["ell2"]["max"], SCAL["m2_ell2_max"])
        close(m.spatial_cov.compKphi_2d(80.0, 1.0), "m2_Kphi", rtol=1e-7)
        close(m.spatial_cov.compKphig_2d(GOLD["m2_z"], 80.0, 1.0), "m2_Kphig",
              rtol=1e-7)
