"""GPCSD1D model tests: dense oracles, fit smoke tests, API parity.

The prediction oracle re-derives the reference's dense-Kronecker formula
(``gpcsd1d.py:248-293``) in numpy and checks the factored path against it.
"""

import jax
import numpy as np
import pytest

import gpcsd_tpu as g
from gpcsd_tpu.models.covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)


def make_model(rng, nx=8, nt=15, ntrials=3, per_channel_noise=False, het_noise="approx"):
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(nx, nt, ntrials))
    sig2n_prior = [g.HalfNormal(0.1) for _ in range(nx)] if per_channel_noise else None
    m = g.GPCSD1D(lfp, x, t, ngl=40, sig2n_prior=sig2n_prior, het_noise=het_noise)
    # pin parameters for determinism
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 5.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.8
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.4
    if per_channel_noise:
        m.sig2n["value"] = rng.uniform(0.01, 0.1, size=nx)
    else:
        m.sig2n["value"] = 0.05
    return m


def dense_cov_parts(m):
    """Dense Ks (with jitter), Kt, sig2n from the model's own cov objects."""
    Ks = np.asarray(m.spatial_cov.compKphi_1d(m.R["value"])) + 1e-8 * np.eye(m.x.shape[0])
    nt = m.t.shape[0]
    Kt = np.zeros((nt, nt))
    for tc in m.temporal_cov_list:
        Kt += np.asarray(tc.compute_Kt())
    return Ks, Kt, np.asarray(m.sig2n["value"])


class TestLoglik:
    def test_matches_dense_gaussian(self, rng):
        m = make_model(rng)
        Ks, Kt, s2 = dense_cov_parts(m)
        nx, nt = Ks.shape[0], Kt.shape[0]
        dense = np.kron(Ks, Kt) + s2 * np.eye(nx * nt)
        _, logdet = np.linalg.slogdet(dense)
        inv = np.linalg.inv(dense)
        want = 0.0
        for tr in range(m.lfp.shape[2]):
            y = m.lfp[:, :, tr].reshape(-1)
            want += -0.5 * logdet - 0.5 * y @ inv @ y
        assert np.allclose(m.loglik(), want, rtol=1e-8)

    def test_per_channel_noise(self, rng):
        m = make_model(rng, per_channel_noise=True)
        Ks, Kt, s2 = dense_cov_parts(m)
        nx, nt = Ks.shape[0], Kt.shape[0]
        ls, Qs = np.linalg.eigh(Ks)
        lt, Qt = np.linalg.eigh(Kt)
        Dvec = np.repeat(ls, nt) * np.tile(lt, nx) + np.repeat(s2, nt)
        want = 0.0
        for tr in range(m.lfp.shape[2]):
            alpha = (Qs.T @ m.lfp[:, :, tr] @ Qt).reshape(-1)
            want += -0.5 * np.sum(np.log(Dvec)) - 0.5 * np.sum(alpha**2 / Dvec)
        assert np.allclose(m.loglik(), want, rtol=1e-8)

    def test_per_channel_noise_exact_mode(self, rng):
        """het_noise='exact' matches the dense Gaussian with per-channel
        noise exactly (the reference approximation cannot)."""
        m = make_model(rng, per_channel_noise=True, het_noise="exact")
        Ks, Kt, s2 = dense_cov_parts(m)
        nx, nt = Ks.shape[0], Kt.shape[0]
        dense = np.kron(Ks, Kt) + np.diag(np.repeat(s2, nt))
        _, logdet = np.linalg.slogdet(dense)
        inv = np.linalg.inv(dense)
        want = 0.0
        for tr in range(m.lfp.shape[2]):
            y = m.lfp[:, :, tr].reshape(-1)
            want += -0.5 * logdet - 0.5 * y @ inv @ y
        assert np.allclose(m.loglik(), want, rtol=1e-8)
        # gradient through the exact path stays finite (NUTS/MAP usable)
        fns = m._fns()
        u = fns.param_set.pack(m._theta())
        g_ = jax.grad(fns.neg_log_joint)(u, m._Y())
        assert np.all(np.isfinite(np.asarray(g_)))

    def test_per_channel_fit_smoke_exact_mode(self, rng):
        m = make_model(rng, nx=5, nt=8, per_channel_noise=True, het_noise="exact")
        m.fit(n_restarts=2, seed=1, options={"maxiter": 30})
        assert np.isfinite(m.fit_result.nll_best)


class TestPredict:
    def test_csd_matches_dense_kron_formula(self, rng):
        m = make_model(rng, nx=6, nt=10, ntrials=2)
        z = np.linspace(50, 450, 9).reshape(-1, 1)
        m.predict(z, m.t, type="both")
        Ks, Kt, s2 = dense_cov_parts(m)
        nx, nt = Ks.shape[0], Kt.shape[0]
        ntr = m.lfp.shape[2]
        dense = np.kron(Ks - 1e-8 * np.eye(nx), Kt) + s2 * np.eye(nx * nt)
        # NOTE: reference predict omits the jitter when building Ks
        # (gpcsd1d.py:258 calls compKphi_1d without adding JITTER)
        invy = np.linalg.solve(dense, m.lfp.reshape(nx * nt, ntr))
        Kphig = np.asarray(m.spatial_cov.compKphig_1d(z, m.R["value"]))
        Kphi = np.asarray(m.spatial_cov.compKphi_1d(m.R["value"], xp=z))
        csd_want = np.zeros((z.shape[0], nt, ntr))
        lfp_want = np.zeros((z.shape[0], nt, ntr))
        for tc in m.temporal_cov_list:
            Ktstar = np.asarray(tc.compute_Kt())  # t* == t here
            csd_want += (np.kron(Kphig, Ktstar).T @ invy).reshape(z.shape[0], nt, ntr)
            lfp_want += (np.kron(Kphi, Ktstar).T @ invy).reshape(z.shape[0], nt, ntr)
        # our predict includes the jitter in Ks (consistent with loglik);
        # tolerance absorbs the 1e-8 difference
        assert np.allclose(m.csd_pred, csd_want, rtol=1e-5, atol=1e-7)
        assert np.allclose(m.lfp_pred, lfp_want, rtol=1e-5, atol=1e-7)
        assert len(m.csd_pred_list) == 2
        assert np.allclose(sum(m.csd_pred_list), m.csd_pred, rtol=1e-10)

    def test_predict_subset_times(self, rng):
        m = make_model(rng, nx=6, nt=12, ntrials=2)
        z = np.linspace(0, 700, 5).reshape(-1, 1)
        tstar = m.t[::3]
        sub = np.array(m.predict(z, tstar, type="csd"))
        assert sub.shape == (5, tstar.shape[0], 2)
        # predicting at a time subset must agree with the full-time prediction
        full = m.predict(z, m.t, type="csd")
        assert np.allclose(sub, full[:, ::3, :], rtol=1e-8)


class TestSamplePrior:
    def test_shape_and_covariance(self, rng):
        m = make_model(rng, nx=5, nt=8)
        csd = m.sample_prior(4000, seed=1)
        assert csd.shape == (5, 8, 4000)
        # empirical spatial covariance at t=0 should approximate Ks_csd * Kt[0,0]
        Ks_csd = np.asarray(m.spatial_cov.compute_Ks())
        Kt = np.zeros((8, 8))
        for tc in m.temporal_cov_list:
            Kt += np.asarray(tc.compute_Kt())
        emp = np.cov(csd[:, 0, :])
        assert np.allclose(emp, Ks_csd * Kt[0, 0], atol=0.15)


class TestFit:
    def test_fit_jax_backend_recovers_signal(self, rng):
        nx, nt = 10, 24
        x = (np.arange(nx) * 50.0).reshape(-1, 1)
        t = np.arange(nt).reshape(-1, 1) * 1.0
        gen = g.GPCSD1D(np.zeros((nx, nt, 1)), x, t, ngl=30)
        gen.R["value"] = 100.0
        gen.spatial_cov.params["ell"]["value"] = 120.0
        gen.temporal_cov_list[0].params["ell"]["value"] = 6.0
        gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
        gen.temporal_cov_list[1].params["ell"]["value"] = 2.0
        gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
        gen.sig2n["value"] = 1e-4
        csd = gen.sample_prior(40, seed=3)
        from gpcsd_tpu.ops.forward import fwd_model_1d

        lfp = np.asarray(
            fwd_model_1d(np.moveaxis(csd, 2, 0), x.ravel(), x.ravel(), 100.0)
        )
        lfp = np.moveaxis(lfp, 0, 2)
        lfp = lfp / np.max(np.abs(lfp))
        m = g.GPCSD1D(lfp, x, t, ngl=30)
        res = m.fit(n_restarts=3, backend="jax", seed=0)
        assert np.isfinite(res.nll_best)
        ll_fit = m.loglik()
        assert np.isfinite(ll_fit)
        # fitted model should beat a generic random initialization
        m2 = g.GPCSD1D(lfp, x, t, ngl=30)
        m2.R["value"] = 150.0
        m2.spatial_cov.params["ell"]["value"] = 200.0
        for tc in m2.temporal_cov_list:
            tc.params["ell"]["value"] = 10.0
            tc.params["sigma2"]["value"] = 0.3
        m2.sig2n["value"] = 0.1
        assert ll_fit > m2.loglik()

    def test_fit_scipy_backend_smoke(self, rng):
        m = make_model(rng, nx=6, nt=10, ntrials=2)
        res = m.fit(n_restarts=2, backend="scipy", seed=1)
        assert np.isfinite(res.nll_best)

    def test_fix_R(self, rng):
        m = make_model(rng, nx=6, nt=10, ntrials=2)
        R0 = m.R["value"]
        m.fit(n_restarts=2, backend="jax", fix_R=True, seed=1)
        assert m.R["value"] == R0

    def test_init_overrides_start_every_restart(self, rng):
        m = make_model(rng, nx=6, nt=10, ntrials=2)
        names = m._fns().param_set.names_flat()
        res = m.fit(n_restarts=3, backend="jax", seed=1, options={
            "maxiter": 0, "init_overrides": {"tm0_ell": 7.0, "tm1_sigma2": 0.3}})
        np.testing.assert_allclose(np.exp(res.u_all[:, names.index("tm0_ell")]), 7.0)
        np.testing.assert_allclose(np.exp(res.u_all[:, names.index("tm1_sigma2")]), 0.3)
        # the priors still draw the rest
        assert np.ptp(res.u_all[:, names.index("tm1_ell")]) > 0

    def test_backends_agree(self, rng):
        """jax and scipy backends reach comparable objective values."""
        m = make_model(rng, nx=6, nt=10, ntrials=2)
        r_jax = m.fit(n_restarts=3, backend="jax", seed=5)
        m2 = make_model(rng, nx=6, nt=10, ntrials=2)
        m2.lfp = m.lfp
        r_scipy = m2.fit(n_restarts=3, backend="scipy", seed=5)
        assert abs(r_jax.nll_best - r_scipy.nll_best) / abs(r_scipy.nll_best) < 0.05


class TestAPI:
    def test_param_roundtrip(self, rng):
        m = make_model(rng)
        p = m.extract_model_params()
        m2 = make_model(rng)
        m2.restore_model_params(p)
        assert m2.R["value"] == m.R["value"]
        assert m2.extract_model_params()["temporal_sigma2_list"] == p["temporal_sigma2_list"]

    def test_update_lfp(self, rng):
        m = make_model(rng, nx=6, nt=10)
        new_t = np.arange(7).reshape(-1, 1) * 1.0
        new_lfp = rng.normal(size=(6, 7, 4))
        m.update_lfp(new_lfp, new_t)
        assert np.isfinite(m.loglik())

    def test_str(self, rng):
        s = str(make_model(rng))
        assert "GPCSD1D" in s and "Temporal covariance 2" in s

    def test_per_channel_fit_smoke(self, rng):
        m = make_model(rng, nx=5, nt=8, per_channel_noise=True)
        res = m.fit(n_restarts=2, backend="jax", seed=2)
        assert np.isfinite(res.nll_best)
        assert np.asarray(m.sig2n["value"]).shape == (5,)
