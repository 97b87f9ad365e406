"""Sampler correctness tests: NUTS on known distributions and on GPCSD1D.

The sampler-validation strategy: exact moments on Gaussians (analytically
known), then posterior sanity on a small GPCSD model (finite, concentrated
near the MAP).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpcsd_tpu.infer.hmc import (
    da_init,
    da_update,
    stan_warmup_schedule,
    welford_init,
    welford_update,
    welford_variance,
)
from gpcsd_tpu.infer.nuts import nuts_chains, nuts_run


class TestWarmupMachinery:
    def test_welford_matches_numpy(self, rng):
        xs = rng.normal(size=(200, 3)) * np.array([1.0, 2.0, 0.5])
        st = welford_init(3)
        for x in xs:
            st = welford_update(st, jnp.asarray(x))
        var = np.asarray(welford_variance(st, regularize=False))
        assert np.allclose(var, xs.var(0, ddof=1), rtol=1e-10)

    def test_dual_averaging_converges_direction(self):
        st = da_init(1.0)
        # constantly too-low acceptance should shrink the step
        for _ in range(50):
            st = da_update(st, jnp.asarray(0.1))
        assert float(st.log_step) < 0
        st2 = da_init(1.0)
        for _ in range(50):
            st2 = da_update(st2, jnp.asarray(1.0))
        assert float(st2.log_step) > 0

    def test_stan_schedule_covers_windows(self):
        slow, end = stan_warmup_schedule(1000)
        assert slow.shape == (1000,)
        assert slow[:75].sum() == 0  # init buffer fast
        assert slow[-50:].sum() == 0  # term buffer fast
        assert end.sum() >= 2  # at least two window refreshes
        assert slow.sum() == 1000 - 75 - 50

    def test_stan_schedule_small(self):
        slow, end = stan_warmup_schedule(10)
        assert slow.sum() == 0  # too short: no mass adaptation


class TestNUTSGaussian:
    def test_correlated_gaussian_moments(self):
        cov = np.array([[2.0, 1.2], [1.2, 1.0]])
        icov = jnp.asarray(np.linalg.inv(cov))

        def lp(u):
            return -0.5 * u @ icov @ u

        u0s = jax.random.normal(jax.random.PRNGKey(1), (4, 2), jnp.float64)
        res = jax.jit(
            lambda u0s, k: nuts_chains(lp, u0s, k, num_warmup=400, num_samples=1500)
        )(u0s, jax.random.PRNGKey(0))
        s = np.asarray(res.samples).reshape(-1, 2)
        assert np.abs(s.mean(0)).max() < 0.15
        assert np.allclose(np.cov(s.T), cov, atol=0.25)
        assert np.asarray(res.diverging).mean() < 0.01

    def test_scale_mismatch_mass_adaptation(self):
        """Badly scaled target: mass adaptation must recover the scales."""
        scales = jnp.asarray([0.05, 1.0, 30.0])

        def lp(u):
            return -0.5 * jnp.sum((u / scales) ** 2)

        res = jax.jit(
            lambda u0, k: nuts_run(lp, u0, k, num_warmup=600, num_samples=1500)
        )(jnp.zeros(3, jnp.float64), jax.random.PRNGKey(2))
        s = np.asarray(res.samples)
        assert np.allclose(s.std(0), np.asarray(scales), rtol=0.25)
        # inverse mass should be ~ variances
        assert np.all(np.asarray(res.inv_mass)[2] > np.asarray(res.inv_mass)[0])

    def test_deterministic_given_key(self):
        def lp(u):
            return -0.5 * jnp.sum(u**2)

        r1 = nuts_run(lp, jnp.zeros(2, jnp.float64), jax.random.PRNGKey(7),
                      num_warmup=50, num_samples=50)
        r2 = nuts_run(lp, jnp.zeros(2, jnp.float64), jax.random.PRNGKey(7),
                      num_warmup=50, num_samples=50)
        assert np.array_equal(np.asarray(r1.samples), np.asarray(r2.samples))


class TestNUTSOnGPCSD:
    def test_posterior_concentrates_near_map(self, rng):
        import gpcsd_tpu as g
        from gpcsd_tpu.ops.forward import fwd_model_1d

        nx, nt = 8, 16
        x = (np.arange(nx) * 80.0).reshape(-1, 1)
        t = np.arange(nt).reshape(-1, 1) * 1.0
        gen = g.GPCSD1D(np.zeros((nx, nt, 1)), x, t, ngl=24)
        gen.R["value"] = 120.0
        gen.spatial_cov.params["ell"]["value"] = 150.0
        gen.temporal_cov_list[0].params["ell"]["value"] = 5.0
        gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
        gen.temporal_cov_list[1].params["ell"]["value"] = 2.0
        gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
        gen.sig2n["value"] = 1e-3
        csd = gen.sample_prior(30, seed=5)
        lfp = np.array(
            np.moveaxis(
                np.asarray(fwd_model_1d(np.moveaxis(csd, 2, 0), x.ravel(), x.ravel(), 120.0)),
                0,
                2,
            )
        )
        lfp /= np.max(np.abs(lfp))
        m = g.GPCSD1D(lfp, x, t, ngl=24)
        fns = m._fns()
        Y = m._Y()

        def lp(u):
            return fns.log_prob(u, Y)

        u0 = fns.param_set.pack(fns.param_set.sample(jax.random.PRNGKey(0)))
        u0 = fns.param_set.clip_to_bounds(u0)
        res = jax.jit(
            lambda u0, k: nuts_run(lp, u0, k, num_warmup=300, num_samples=300, max_depth=8)
        )(u0, jax.random.PRNGKey(1))
        assert np.isfinite(np.asarray(res.logp)).all()
        assert np.asarray(res.diverging).mean() < 0.2
        # posterior mean params should produce a finite, competitive loglik
        u_mean = jnp.asarray(np.asarray(res.samples).mean(0))
        theta = fns.param_set.unpack(u_mean)
        ll = float(fns.loglik(theta, Y))
        assert np.isfinite(ll)


class TestChunkedNUTS:
    def test_chunked_matches_gaussian_moments(self):
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        cov = np.array([[2.0, 1.2], [1.2, 1.0]])
        icov = jnp.asarray(np.linalg.inv(cov))

        def lp(u):
            return -0.5 * u @ icov @ u

        u0s = jax.random.normal(jax.random.PRNGKey(1), (4, 2), jnp.float64)
        res = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(0), num_warmup=300, num_samples=700,
            chunk_size=25,
        )
        s = res.samples.reshape(-1, 2)
        assert np.allclose(np.cov(s.T), cov, atol=0.3)
        assert res.diverging.mean() < 0.01

    def test_pooled_warmup_shares_metric(self):
        """pool_warmup=True: chains share Welford stats, so the adapted
        inverse mass is (near-)identical across chains and moments hold."""
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        scales = jnp.asarray([0.5, 4.0, 1.0])

        def lp(u):
            return -0.5 * jnp.sum((u / scales) ** 2)

        u0s = jax.random.normal(jax.random.PRNGKey(3), (4, 3), jnp.float64)
        res_p = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(0), num_warmup=300, num_samples=500,
            chunk_size=20, pool_warmup=True,
        )
        res_u = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(0), num_warmup=300, num_samples=500,
            chunk_size=20, pool_warmup=False,
        )
        # pooling shrinks the cross-chain dispersion of the adapted metric
        # (the refresh at a window end still adds a small per-chain tail
        # since the last chunk boundary, so equality is approximate)
        spread = lambda im: float(np.mean(np.std(np.log(im), axis=0)))
        assert spread(res_p.inv_mass) < spread(res_u.inv_mass)
        # pooled metric reflects the true marginal variances (0.25, 16, 1)
        im = np.asarray(res_p.inv_mass).mean(axis=0)
        assert im[0] < im[2] < im[1]
        s = res_p.samples.reshape(-1, 3)
        assert np.allclose(s.var(axis=0), np.asarray(scales) ** 2, rtol=0.35)

    def test_state_path_resume_is_exact(self, tmp_path):
        """Kill the driver mid-run; rerunning with the same state_path must
        resume from the last completed chunk and produce bit-identical
        samples to an uninterrupted run (crash recovery)."""
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        def lp(u):
            return -0.5 * jnp.sum(u**2)

        u0s = jax.random.normal(jax.random.PRNGKey(5), (2, 3), jnp.float64)
        kw = dict(num_warmup=30, num_samples=30, chunk_size=10, max_depth=5)
        ref = nuts_chains_chunked(lp, u0s, jax.random.PRNGKey(9), **kw)

        sp = str(tmp_path / "nuts_state")

        class Boom(RuntimeError):
            pass

        def killer(c, carry):
            if c == 2:
                raise Boom()

        try:
            nuts_chains_chunked(
                lp, u0s, jax.random.PRNGKey(9), **kw, state_path=sp,
                callback=killer,
            )
            raise AssertionError("killer callback did not fire")
        except Boom:
            pass
        seen = []
        res = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(9), **kw, state_path=sp,
            callback=lambda c, carry: seen.append(c),
        )
        # the rerun must actually RESUME (chunks 0-2 were checkpointed),
        # not silently restart from scratch
        assert seen and seen[0] == 3, seen
        assert np.array_equal(res.samples, ref.samples)
        assert np.array_equal(res.num_steps, ref.num_steps)

    def test_stepsize_floor_guard_repairs_collapsed_chain(self):
        """A chain whose dual-averaged step collapsed orders of magnitude
        below the pack gets its FULL state (position, grads, adaptation,
        metric, aux) replaced by the healthiest chain's (VERDICT r4 weak
        #5 — the 2D probe burned half its budget on two ~1e-9 chains)."""
        import jax.numpy as jnp

        from gpcsd_tpu.infer.hmc import DualAveragingState
        from gpcsd_tpu.infer.nuts import stepsize_floor_guard

        nchains, dim = 4, 3
        rng = np.random.default_rng(0)
        z = jnp.asarray(rng.normal(size=(nchains, dim)))
        logp = jnp.asarray(rng.normal(size=(nchains,)))
        grad = jnp.asarray(rng.normal(size=(nchains, dim)))
        steps = np.array([0.4, 1e-9, 0.2, 3e-10])  # chains 1, 3 collapsed
        ls = jnp.log(jnp.asarray(steps))
        da = DualAveragingState(
            log_step=ls, log_step_avg=ls, h_sum=jnp.zeros(nchains),
            mu=ls + np.log(10.0), count=jnp.zeros(nchains, jnp.int32),
        )
        wf = jnp.asarray(rng.normal(size=(nchains, dim)))  # stand-in leaf
        inv_mass = jnp.asarray(rng.normal(size=(nchains, dim)) ** 2)
        aux = {"qt": jnp.asarray(rng.normal(size=(nchains, 5, 5)))}
        carry = (z, logp, grad, da, wf, inv_mass, aux)
        import pytest

        with pytest.warns(UserWarning, match="floor guard"):
            fixed = stepsize_floor_guard(carry, nchains, chunk=7)
        donor = 0  # argmax step
        for sick in (1, 3):
            assert np.array_equal(fixed[0][sick], np.asarray(z[donor]))
            assert np.array_equal(fixed[2][sick], np.asarray(grad[donor]))
            assert np.isclose(
                np.exp(np.asarray(fixed[3].log_step_avg)[sick]), 0.4
            )
            assert np.array_equal(
                fixed[6]["qt"][sick], np.asarray(aux["qt"][donor])
            )
        # healthy chain 2 untouched
        assert np.array_equal(fixed[0][2], np.asarray(z[2]))
        assert np.isclose(np.exp(np.asarray(fixed[3].log_step_avg)[2]), 0.2)

    def test_stepsize_floor_guard_noop_on_healthy_chains(self):
        from gpcsd_tpu.infer.hmc import DualAveragingState
        from gpcsd_tpu.infer.nuts import stepsize_floor_guard

        nchains = 4
        ls = jnp.log(jnp.asarray([0.4, 0.3, 0.2, 0.25]))
        da = DualAveragingState(
            log_step=ls, log_step_avg=ls, h_sum=jnp.zeros(nchains),
            mu=ls, count=jnp.zeros(nchains, jnp.int32),
        )
        z = jnp.asarray(np.random.default_rng(1).normal(size=(nchains, 2)))
        carry = (z, z[:, 0], z, da, z, z, ())
        fixed = stepsize_floor_guard(carry, nchains)
        assert fixed is carry  # identity: no surgery, no copies

    def test_stepsize_floor_guard_majority_collapse(self):
        """3 of 4 chains collapsed: the healthy-chain median must not be
        dragged down to the collapsed scale — all three get repaired."""
        from gpcsd_tpu.infer.hmc import DualAveragingState
        from gpcsd_tpu.infer.nuts import stepsize_floor_guard

        nchains = 4
        steps = np.array([1e-9, 2e-9, 0.4, 3e-10])
        ls = jnp.log(jnp.asarray(steps))
        da = DualAveragingState(
            log_step=ls, log_step_avg=ls, h_sum=jnp.zeros(nchains),
            mu=ls, count=jnp.zeros(nchains, jnp.int32),
        )
        z = jnp.asarray(np.random.default_rng(2).normal(size=(nchains, 2)))
        import pytest

        with pytest.warns(UserWarning, match="floor guard"):
            fixed = stepsize_floor_guard((z, z[:, 0], z, da, z, z, ()), nchains)
        s_fixed = np.exp(np.asarray(fixed[3].log_step_avg))
        assert np.allclose(s_fixed, 0.4)

    def test_dense_mass_matches_moments_and_shortens_trees(self):
        """Dense-metric NUTS (round-4 geometry lever): on a correlated
        Gaussian the adapted full-covariance metric must (a) recover the
        target moments, (b) produce substantially SHORTER trajectories
        than the diagonal metric (which must fight the correlation), and
        (c) work through the chunked driver with cross-chain pooling."""
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked, nuts_run

        cov = np.array([[2.0, 1.2, 0.0], [1.2, 1.0, 0.3], [0.0, 0.3, 0.5]])
        icov = jnp.asarray(np.linalg.inv(cov))

        def lp(u):
            return -0.5 * u @ icov @ u

        res = nuts_run(lp, jnp.zeros(3, jnp.float64), jax.random.PRNGKey(0),
                       num_warmup=500, num_samples=1500, dense_mass=True)
        assert np.asarray(res.inv_mass).shape == (3, 3)
        s = np.asarray(res.samples)
        assert np.allclose(np.cov(s.T), cov, atol=0.35)
        res_diag = nuts_run(lp, jnp.zeros(3, jnp.float64),
                            jax.random.PRNGKey(0), num_warmup=500,
                            num_samples=1500)
        assert (
            np.asarray(res.num_steps).mean()
            < 0.7 * np.asarray(res_diag.num_steps).mean()
        )

        u0s = jax.random.normal(jax.random.PRNGKey(1), (4, 3), jnp.float64)
        rc = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(0), num_warmup=300, num_samples=500,
            chunk_size=25, dense_mass=True, pool_warmup=True,
        )
        sc = rc.samples.reshape(-1, 3)
        assert rc.inv_mass.shape == (4, 3, 3)
        assert np.allclose(np.cov(sc.T), cov, atol=0.35)

    def test_aot_program_cache(self, tmp_path):
        """state_path runs serialize the traced chunk program
        (``<state>.chunk_aot.bin``); a fresh driver with matching
        code+config fingerprint deserializes it (skipping re-tracing,
        PERF.md round-4 'compile tax') and must produce bit-identical
        samples; a stale fingerprint is ignored, not an error."""
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        def lp(u):
            return -0.5 * jnp.sum(u**2)

        u0s = jax.random.normal(jax.random.PRNGKey(5), (2, 3), jnp.float64)
        kw = dict(num_warmup=10, num_samples=10, chunk_size=5, max_depth=4)
        ref = nuts_chains_chunked(lp, u0s, jax.random.PRNGKey(9), **kw)

        sp = str(tmp_path / "s1")
        r1 = nuts_chains_chunked(lp, u0s, jax.random.PRNGKey(9), **kw,
                                 state_path=sp)
        aot = sp + ".chunk_aot.bin"
        assert os.path.exists(aot), "AOT program was not serialized"
        assert np.array_equal(r1.samples, ref.samples)

        # fresh driver, same config: must go through deserialize and agree
        for f in (sp + ".npz",):
            os.remove(f)
        r2 = nuts_chains_chunked(lp, u0s, jax.random.PRNGKey(9), **kw,
                                 state_path=sp)
        assert np.array_equal(r2.samples, ref.samples)

        # corrupt/stale header: silently falls back and re-serializes
        with open(aot, "r+b") as f:
            f.write(b"stale-fingerprint-x")
        os.remove(sp + ".npz")
        r3 = nuts_chains_chunked(lp, u0s, jax.random.PRNGKey(9), **kw,
                                 state_path=sp)
        assert np.array_equal(r3.samples, ref.samples)

    def test_chunk_padding(self):
        """total not divisible by chunk_size: padded steps must be no-ops."""
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        def lp(u):
            return -0.5 * jnp.sum(u**2)

        u0s = jnp.zeros((2, 3), jnp.float64)
        res = nuts_chains_chunked(
            lp, u0s, jax.random.PRNGKey(2), num_warmup=17, num_samples=23,
            chunk_size=10,
        )
        assert res.samples.shape == (2, 23, 3)
        assert np.isfinite(res.samples).all()

    def test_model_api_chunked(self, rng):
        import gpcsd_tpu as g

        x = (np.arange(6) * 100.0).reshape(-1, 1)
        t = np.arange(10).reshape(-1, 1) * 1.0
        m = g.GPCSD1D(rng.normal(size=(6, 10, 3)) * 0.5, x, t, ngl=16)
        m.R["value"] = 120.0
        m.spatial_cov.params["ell"]["value"] = 180.0
        m.temporal_cov_list[0].params["ell"]["value"] = 4.0
        m.temporal_cov_list[0].params["sigma2"]["value"] = 0.5
        m.temporal_cov_list[1].params["ell"]["value"] = 1.5
        m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
        m.sig2n["value"] = 0.1
        post = m.sample_posterior(
            n_chains=2, num_warmup=30, num_samples=30, seed=0, max_depth=5,
            chunk_size=8,
        )
        assert post.theta["R"].shape == (60,)
        assert (post.theta["R"] > 0).all()

    def test_model_api_gpcsd2d(self, rng):
        """The full sampler stack (Laplace whitening + chunked NUTS +
        diagnostics) drives the 2D model through the same mixin as 1D —
        the reference has no 2D posterior story at all
        (``gpcsd2d.py`` is MAP-only)."""
        import gpcsd_tpu as g
        from gpcsd_tpu.utils.grids import expand_grid

        x = expand_grid(np.arange(2) * 40.0, np.arange(4) * 50.0)
        t = np.arange(8).reshape(-1, 1) * 1.0
        m = g.GPCSD2D(rng.normal(size=(8, 8, 2)) * 0.5, x, t, ngl1=6, ngl2=8)
        m.R["value"] = 60.0
        m.spatial_cov.params["ell1"]["value"] = 50.0
        m.spatial_cov.params["ell2"]["value"] = 80.0
        m.temporal_cov_list[0].params["ell"]["value"] = 3.0
        m.temporal_cov_list[0].params["sigma2"]["value"] = 0.5
        m.temporal_cov_list[1].params["ell"]["value"] = 1.5
        m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
        m.sig2n["value"] = 0.1
        post = m.sample_posterior(
            n_chains=2, num_warmup=20, num_samples=20, seed=0, max_depth=5,
            chunk_size=10,
        )
        for k in ("R", "ell1", "ell2", "sig2n"):
            assert post.theta[k].shape == (40,)
            assert np.isfinite(post.theta[k]).all()
        assert (post.theta["R"] > 0).all()
        assert np.isfinite(np.asarray(post.diagnostics["step_size"])).all()

    def test_advi_smc_gpcsd2d(self, rng):
        """ADVI and SMC drive the 2D model through the shared mixin."""
        import gpcsd_tpu as g
        from gpcsd_tpu.utils.grids import expand_grid

        x = expand_grid(np.arange(2) * 40.0, np.arange(3) * 50.0)
        t = np.arange(6).reshape(-1, 1) * 1.0
        m = g.GPCSD2D(rng.normal(size=(6, 6, 2)) * 0.5, x, t, ngl1=5, ngl2=6)
        m.spatial_cov.params["ell1"]["value"] = 50.0
        m.spatial_cov.params["ell2"]["value"] = 80.0
        m.sig2n["value"] = 0.1
        post = m.advi(num_steps=60, n_mc=2, n_draws=50, seed=0)
        assert post.theta["R"].shape == (50,)
        assert np.isfinite(post.theta["ell1"]).all()
        post = m.smc(n_particles=32, n_mutation_steps=2, seed=0)
        assert np.isfinite(post.theta["R"]).all()
        assert np.isfinite(post.diagnostics["log_evidence"])


class TestLBFGSChunked:
    def test_chunked_matches_monolithic_bitwise(self, rng):
        """The host-chunked batched driver must produce the exact iterates
        of vmap(lbfgs_minimize) — the chunk boundary only splits the
        while_loop."""
        import jax
        import jax.numpy as jnp

        from gpcsd_tpu.infer.lbfgs import lbfgs_minimize, lbfgs_minimize_chunked

        def rosen(u):
            return jnp.sum(100.0 * (u[1:] - u[:-1] ** 2) ** 2 + (1 - u[:-1]) ** 2)

        u0s = jnp.asarray(rng.normal(size=(6, 4)))
        lo, hi = jnp.full(4, -2.0), jnp.full(4, 2.0)
        mono = jax.jit(jax.vmap(
            lambda u0: lbfgs_minimize(rosen, u0, lo=lo, hi=hi, max_iter=200)
        ))(u0s)
        chunked = lbfgs_minimize_chunked(
            rosen, u0s, lo=lo, hi=hi, max_iter=200, chunk_iters=7
        )
        assert np.array_equal(np.asarray(mono.u), np.asarray(chunked.u))
        assert np.array_equal(np.asarray(mono.f), np.asarray(chunked.f))
        assert np.array_equal(np.asarray(mono.n_iter), np.asarray(chunked.n_iter))
        assert np.array_equal(
            np.asarray(mono.converged), np.asarray(chunked.converged)
        )

    def test_chunked_state_checkpoint_resume(self, rng, tmp_path):
        """state_path checkpoints every chunk; a rerun resumes (here: from
        the finished checkpoint) and returns identical results."""
        import jax
        import jax.numpy as jnp

        from gpcsd_tpu.infer.lbfgs import lbfgs_minimize_chunked

        def rosen(u):
            return jnp.sum(100.0 * (u[1:] - u[:-1] ** 2) ** 2 + (1 - u[:-1]) ** 2)

        u0s = jnp.asarray(rng.normal(size=(5, 4)))
        lo, hi = jnp.full(4, -2.0), jnp.full(4, 2.0)
        sp = str(tmp_path / "lbfgs_state")
        kw = dict(lo=lo, hi=hi, max_iter=100, chunk_iters=7, state_path=sp)
        a = lbfgs_minimize_chunked(rosen, u0s, **kw)
        b = lbfgs_minimize_chunked(rosen, u0s, **kw)  # resumes, no new work
        assert np.array_equal(np.asarray(a.u), np.asarray(b.u))
        assert np.array_equal(np.asarray(a.f), np.asarray(b.f))
        # a different run configuration refuses the checkpoint
        import warnings

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            c = lbfgs_minimize_chunked(
                rosen, u0s, lo=lo, hi=hi, max_iter=90, chunk_iters=7,
                state_path=sp,
            )
        assert any("different run" in str(x.message) for x in w)
        assert np.isfinite(np.asarray(c.f)).all()

    def test_time_budget_pause_and_resume(self, rng, tmp_path):
        """max_wall_seconds pauses cleanly at a chunk boundary (state
        saved); rerunning the same call continues to the same answer."""
        import jax.numpy as jnp
        import pytest

        from gpcsd_tpu.infer.lbfgs import (
            LBFGSTimeBudget,
            lbfgs_minimize_chunked,
        )

        def rosen(u):
            return jnp.sum(100.0 * (u[1:] - u[:-1] ** 2) ** 2 + (1 - u[:-1]) ** 2)

        u0s = jnp.asarray(rng.normal(size=(3, 4)))
        sp = str(tmp_path / "st")
        kw = dict(max_iter=200, chunk_iters=1, state_path=sp)
        with pytest.raises(LBFGSTimeBudget):
            lbfgs_minimize_chunked(rosen, u0s, max_wall_seconds=0.0, **kw)
        res = lbfgs_minimize_chunked(rosen, u0s, **kw)  # resume, no budget
        ref = lbfgs_minimize_chunked(
            rosen, u0s, max_iter=200, chunk_iters=1,
            state_path=str(tmp_path / "st2"),
        )
        np.testing.assert_array_equal(np.asarray(res.u), np.asarray(ref.u))
        with pytest.raises(ValueError, match="state_path"):
            lbfgs_minimize_chunked(rosen, u0s, max_wall_seconds=1.0)
