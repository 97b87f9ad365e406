"""High-level posterior inference API on the model classes."""

import jax
import numpy as np
import pytest

import gpcsd_tpu as g


@pytest.fixture
def small_model(rng):
    nx, nt, ntrials = 6, 10, 4
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(nx, nt, ntrials)) * 0.5
    m = g.GPCSD1D(lfp, x, t, ngl=20)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 4.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.5
    m.temporal_cov_list[1].params["ell"]["value"] = 1.5
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    m.sig2n["value"] = 0.1
    return m


class TestSamplePosterior:
    def test_nuts_returns_constrained_samples(self, small_model):
        post = small_model.sample_posterior(
            n_chains=2, num_warmup=50, num_samples=40, seed=0, max_depth=6
        )
        assert set(post.theta) >= {"R", "ell", "sig2n", "tm0_ell", "tm1_sigma2"}
        assert post.theta["R"].shape == (80,)
        assert (post.theta["R"] > 0).all()
        assert (post.theta["sig2n"] > 0).all()
        assert np.isfinite(post.diagnostics["accept_prob"]).all()

    def test_init_modes(self, small_model):
        """Default init starts chains at the current (MAP-like) params with
        u-space jitter; init='prior' keeps prior draws; bad names raise."""
        post = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=10, seed=0, max_depth=5,
            init="prior",
        )
        assert np.isfinite(post.theta["R"]).all()
        post2 = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=10, seed=0, max_depth=5,
            init="params_jitter",
        )
        assert np.isfinite(post2.theta["R"]).all()
        with pytest.raises(ValueError, match="unknown init"):
            small_model.sample_posterior(
                n_chains=2, num_warmup=2, num_samples=2, init="nope"
            )

    def test_nuts_with_mesh(self, small_model):
        from gpcsd_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(chain=2, trial=4)
        post = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=20, seed=0, max_depth=5, mesh=mesh
        )
        assert post.theta["R"].shape == (40,)
        assert np.isfinite(post.theta["R"]).all()

    def test_set_posterior_mean(self, small_model):
        R_before = small_model.R["value"]
        small_model.sample_posterior(
            n_chains=1, num_warmup=30, num_samples=30, seed=1, max_depth=5,
            set_posterior_mean=True,
        )
        assert small_model.R["value"] != R_before
        assert np.isfinite(small_model.loglik())


class TestLaplaceWhitening:
    def test_moments_invariant_under_whitening(self, small_model):
        """Laplace (MAP-Hessian) whitening is an exact constant linear
        reparameterization — posteriors with/without it must agree in
        moments (loose MC tolerances)."""
        post_w = small_model.sample_posterior(
            n_chains=2, num_warmup=120, num_samples=120, seed=5, max_depth=6,
            laplace=True,
        )
        post_p = small_model.sample_posterior(
            n_chains=2, num_warmup=120, num_samples=120, seed=6, max_depth=6,
            laplace=False,
        )
        for name in ("R", "ell", "tm0_ell", "sig2n"):
            a = np.log(post_w.theta[name])
            b = np.log(post_p.theta[name])
            tol = 0.6 * max(a.std(), b.std()) + 0.15
            assert abs(a.mean() - b.mean()) < tol, (name, a.mean(), b.mean())
        # whitened samples are mapped back to u-space: constrained draws
        # must respect the parameter box exactly like the plain path
        assert (post_w.theta["sig2n"] > 0).all()

    def test_precomputed_hessian(self, small_model, tmp_path):
        """laplace_hessian accepts a (dim, dim) array or an .npz path with
        key H (the scripts/laplace_hessian.py artifact) and skips the
        in-process Hessian computation entirely."""
        import jax as _jax
        import jax.numpy as jnp

        fns = small_model._fns()
        Y = small_model._Y()
        u0 = jnp.asarray(fns.param_set.pack(small_model._theta()))
        dim = u0.shape[0]
        h = 1e-4
        eye = h * jnp.eye(dim, dtype=u0.dtype)
        pts = jnp.concatenate([u0[None] + eye, u0[None] - eye], axis=0)
        gs = _jax.vmap(_jax.grad(lambda u: fns.neg_log_joint(u, Y)))(pts)
        H = np.asarray((gs[:dim] - gs[dim:]) / (2 * h)).T
        H = 0.5 * (H + H.T)

        post = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=10, seed=3, max_depth=5,
            laplace=True, laplace_hessian=H,
        )
        assert np.isfinite(post.theta["R"]).all()

        path = str(tmp_path / "hess.npz")
        np.savez(path, H=H)
        post2 = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=10, seed=3, max_depth=5,
            laplace=True, laplace_hessian=path,
        )
        # same seed + same Hessian => identical whitening and draws
        np.testing.assert_allclose(post.theta["R"], post2.theta["R"])

        with pytest.raises(ValueError, match="laplace_hessian"):
            small_model.sample_posterior(
                n_chains=2, num_warmup=2, num_samples=2,
                laplace=True, laplace_hessian=np.eye(dim + 1),
            )

    def test_fd_hessian_fallback(self, small_model, monkeypatch):
        """When second-order AD yields non-finite entries the sampler falls
        back to a finite-difference Hessian and still runs."""
        import jax as _jax

        real_hessian = _jax.hessian

        def bad_hessian(f):  # simulate a NaN-producing AD Hessian
            fn = real_hessian(f)
            return lambda u: fn(u) * np.nan

        monkeypatch.setattr(_jax, "hessian", bad_hessian)
        post = small_model.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=10, seed=7, max_depth=5,
            laplace=True,
        )
        assert np.isfinite(post.theta["R"]).all()


class TestADVI:
    def test_advi_runs(self, small_model):
        post = small_model.advi(num_steps=300, n_mc=4, seed=0)
        assert post.theta["R"].shape == (1000,)
        assert (post.theta["R"] > 0).all()
        elbo = post.diagnostics["elbo"]
        assert np.nanmean(elbo[-50:]) >= np.nanmean(elbo[:50]) - 1.0


class TestSMC:
    def test_smc_runs(self, small_model):
        post = small_model.smc(n_particles=128, n_mutation_steps=4, seed=0)
        assert post.theta["R"].shape == (128,)
        assert np.isfinite(post.diagnostics["log_evidence"])
        assert int(post.diagnostics["n_stages"]) >= 1


class TestCrossSamplerConsistency:
    def test_nuts_and_smc_agree_on_moments(self, small_model):
        """Two independent inference engines must land on the same posterior
        (loose MC tolerances; small model so both mix well)."""
        post_nuts = small_model.sample_posterior(
            n_chains=2, num_warmup=150, num_samples=150, seed=3, max_depth=6
        )
        post_smc = small_model.smc(n_particles=512, n_mutation_steps=8, seed=4)
        for name in ("R", "ell", "tm0_ell", "sig2n"):
            a = np.log(post_nuts.theta[name])
            b = np.log(post_smc.theta[name])
            # compare log-space means within half a posterior sd (+ slack)
            tol = 0.6 * max(a.std(), b.std()) + 0.15
            assert abs(a.mean() - b.mean()) < tol, (name, a.mean(), b.mean())


class TestADVIMesh:
    def test_advi_with_mesh(self, small_model):
        from gpcsd_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(chain=1, trial=4)
        post = small_model.advi(num_steps=120, n_mc=4, seed=2, mesh=mesh, n_draws=64)
        assert post.theta["R"].shape == (64,)
        assert (post.theta["R"] > 0).all()


class TestUnpackFloor:
    def test_extreme_negative_u_stays_positive_and_finite(self):
        """In a float32 range exp(u) flushes to exactly 0 below ~-87,
        which turns priors into -inf cliffs where float64 stays finite.
        The bijector floors constrained values just above the flush
        threshold on every backend."""
        import numpy as np
        import jax.numpy as jnp
        import gpcsd_tpu as g

        m = g.GPCSD1D(
            np.zeros((4, 8, 2)),
            (np.arange(4) * 100.0).reshape(-1, 1),
            np.arange(8.0).reshape(-1, 1),
            ngl=12,
        )
        fns = m._fns()
        u = np.full(fns.param_set.dim, -200.0)
        theta = fns.param_set.unpack(jnp.asarray(u))
        for k, v in theta.items():
            assert np.all(np.asarray(v) >= fns.param_set.VALUE_FLOOR), k
        lp = float(fns.log_prior_u(jnp.asarray(u)))
        assert not np.isnan(lp)  # astronomically negative is fine; nan is not
