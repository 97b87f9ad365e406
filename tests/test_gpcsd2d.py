"""GPCSD2D model tests (dense oracles + fit smoke) and trad-CSD baselines."""

import numpy as np
import pytest

import gpcsd_tpu as g
from gpcsd_tpu.utils.grids import expand_grid


def make_model(rng, nx1=3, nx2=8, nt=10, ntrials=2):
    x = expand_grid(np.arange(nx1) * 40.0, np.arange(nx2) * 50.0)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(x.shape[0], nt, ntrials))
    m = g.GPCSD2D(lfp, x, t, ngl1=8, ngl2=16)
    m.R["value"] = 60.0
    m.spatial_cov.params["ell1"]["value"] = 50.0
    m.spatial_cov.params["ell2"]["value"] = 80.0
    m.temporal_cov_list[0].params["ell"]["value"] = 4.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.7
    m.temporal_cov_list[1].params["ell"]["value"] = 1.5
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    m.sig2n["value"] = 0.1
    return m


class TestLoglik:
    def test_matches_dense_gaussian(self, rng):
        m = make_model(rng)
        Ks = np.asarray(m.spatial_cov.compKphi_2d(m.R["value"], m.eps)) + 1e-7 * np.eye(
            m.x.shape[0]
        )
        nt = m.t.shape[0]
        Kt = np.zeros((nt, nt))
        for tc in m.temporal_cov_list:
            Kt += np.asarray(tc.compute_Kt())
        nx = Ks.shape[0]
        dense = np.kron(Ks, Kt) + m.sig2n["value"] * np.eye(nx * nt)
        _, logdet = np.linalg.slogdet(dense)
        inv = np.linalg.inv(dense)
        want = 0.0
        for tr in range(m.lfp.shape[2]):
            y = m.lfp[:, :, tr].reshape(-1)
            want += -0.5 * logdet - 0.5 * y @ inv @ y
        assert np.allclose(m.loglik(), want, rtol=1e-6)


class TestPredict:
    def test_predict_shapes_and_decomposition(self, rng):
        m = make_model(rng)
        z = expand_grid(np.linspace(0, 80, 4), np.linspace(0, 350, 6))
        m.predict(z, m.t, type="both")
        assert m.csd_pred.shape == (24, 10, 2)
        assert m.lfp_pred.shape == (24, 10, 2)
        assert np.allclose(sum(m.csd_pred_list), m.csd_pred, rtol=1e-10)

    def test_predict_matches_dense_kron(self, rng):
        m = make_model(rng, nx1=2, nx2=5, nt=6)
        z = m.x[:4] + 3.0
        m.predict(z, m.t, type="csd")
        nx, nt, ntr = m.lfp.shape
        Ks = np.asarray(m.spatial_cov.compKphi_2d(m.R["value"], m.eps)) + 1e-7 * np.eye(nx)
        Kt = np.zeros((nt, nt))
        for tc in m.temporal_cov_list:
            Kt += np.asarray(tc.compute_Kt())
        dense = np.kron(Ks, Kt) + m.sig2n["value"] * np.eye(nx * nt)
        invy = np.linalg.solve(dense, m.lfp.reshape(nx * nt, ntr))
        Kphig = np.asarray(m.spatial_cov.compKphig_2d(z, m.R["value"], m.eps))
        want = np.zeros((z.shape[0], nt, ntr))
        for tc in m.temporal_cov_list:
            Ktstar = np.asarray(tc.compute_Kt())
            want += (np.kron(Kphig, Ktstar).T @ invy).reshape(z.shape[0], nt, ntr)
        assert np.allclose(m.csd_pred, want, rtol=1e-6, atol=1e-8)


class TestSamplePrior:
    def test_csd_only(self, rng):
        m = make_model(rng)
        csd, lfp = m.sample_prior(5, type="csd", seed=2)
        assert csd.shape == (24, 10, 5)
        assert np.all(np.isfinite(csd))
        assert np.all(np.isnan(lfp))

    def test_both(self, rng):
        m = make_model(rng)
        csd, lfp = m.sample_prior(3, type="both", seed=2)
        assert np.all(np.isfinite(csd))
        assert np.all(np.isfinite(lfp))


class TestFit:
    def test_fit_jax_smoke(self, rng):
        m = make_model(rng)
        res = m.fit(n_restarts=2, backend="jax", seed=0)
        assert np.isfinite(res.nll_best)

    def test_init_overrides_start_every_restart(self, rng):
        m = make_model(rng)
        names = m._fns().param_set.names_flat()
        res = m.fit(n_restarts=2, backend="jax", seed=0, options={
            "maxiter": 0, "init_overrides": {"tm0_ell": 7.0}})
        np.testing.assert_allclose(np.exp(res.u_all[:, names.index("tm0_ell")]), 7.0)

    def test_param_roundtrip(self, rng):
        m = make_model(rng)
        p = m.extract_model_params()
        m2 = make_model(rng)
        m2.restore_model_params(p)
        assert m2.extract_model_params() == p

    def test_str(self, rng):
        s = str(make_model(rng))
        assert "GPCSD2D" in s  # reference mislabels this; we don't (SURVEY §5)


class TestTradCSD:
    def test_1d_matches_loop(self, rng):
        lfp = rng.normal(size=(6, 4, 3))
        got = g.predictcsd_trad_1d(lfp)
        want = np.zeros_like(lfp)
        for x in range(1, 5):
            want[x] = lfp[x + 1] + lfp[x - 1] - 2 * lfp[x]
        assert np.allclose(got, -want)
        assert np.all(got[0] == 0) and np.all(got[-1] == 0)

    def test_2d_matches_loop(self, rng):
        lfp = rng.normal(size=(3, 5, 4, 2))
        got = g.predictcsd_trad_2d(lfp)
        want = np.nan * np.ones_like(lfp)
        for row in range(3):
            for col in range(1, 4):
                want[row, col] = (
                    lfp[row, col + 1] + lfp[row, col - 1] - 2 * lfp[row, col]
                )
        assert np.allclose(got[:, 1:-1], -want[:, 1:-1])
        assert np.all(np.isnan(got[:, 0])) and np.all(np.isnan(got[:, -1]))
