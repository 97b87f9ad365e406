"""Warm-started temporal eigenbasis threading (NUTS trajectory aux state).

The sampler hot loop can solve the temporal eigh in the basis carried from
the previous leapfrog step (``ModelFns.log_prob_basis``); exactness requires
that the log-density and its gradient are invariant to the basis, and that
the carried basis stays orthogonal over long products of f32 factors.
These tests pin the math on CPU float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpcsd_tpu as g
from gpcsd_tpu.ops import kronlik


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(3)
    nx, nt, ntrials = 8, 24, 5
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(nx, nt, ntrials))
    m = g.GPCSD1D(lfp, x, t, ngl=30)
    m.R["value"] = 200.0
    m.spatial_cov.params["ell"]["value"] = 150.0
    m.temporal_cov_list[0].params["ell"]["value"] = 6.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.4
    m.sig2n["value"] = 0.1
    return m


def _random_orthogonal(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n))
    q, _ = np.linalg.qr(a)
    return jnp.asarray(q)


class TestLogProbBasis:
    def test_value_and_grad_invariant_to_basis(self, model):
        fns = model._fns(precondition=True)
        Y = model._Y()
        u = fns.param_set.pack(model._theta())
        vg_plain = jax.value_and_grad(lambda u: fns.log_prob(u, Y))
        vg_warm = jax.value_and_grad(
            lambda u, qb: fns.log_prob_basis(u, Y, qb), has_aux=True
        )
        lp0, g0 = vg_plain(u)
        nt = model.t.size
        for seed, qb in ((0, jnp.eye(nt)), (1, _random_orthogonal(nt, 1)),
                         (2, jnp.asarray(fns.qt0))):
            (lp, qt), gr = vg_warm(u, qb)
            np.testing.assert_allclose(float(lp), float(lp0), rtol=1e-9)
            np.testing.assert_allclose(np.asarray(gr), np.asarray(g0), rtol=1e-7)
            # returned basis diagonalizes Kt and is orthogonal
            defect = np.linalg.norm(np.asarray(qt.T @ qt) - np.eye(nt))
            assert defect < 1e-8

    def test_returned_basis_is_fixed_point(self, model):
        """Re-evaluating in the returned basis reproduces value and basis —
        the warm-start chain is self-consistent."""
        fns = model._fns(precondition=True)
        Y = model._Y()
        u = fns.param_set.pack(model._theta())
        lp1, qt1 = fns.log_prob_basis(u, Y, jnp.eye(model.t.size))
        lp2, qt2 = fns.log_prob_basis(u, Y, qt1)
        np.testing.assert_allclose(float(lp2), float(lp1), rtol=1e-10)
        # same subspaces: |qt1^T qt2| should be a signed permutation ~ I
        ov = np.abs(np.asarray(qt1.T @ qt2))
        np.testing.assert_allclose(np.sort(ov.max(axis=0)), 1.0, atol=1e-7)

    def test_dict_basis_threads_spatial(self, model):
        """The dict-valued basis aux (round-4 spatial threading) must (a)
        keep the log-density exactly basis-invariant, (b) mirror the input
        structure, and (c) advance the spatial slot with an orthogonal
        basis that stays a fixed point under re-evaluation."""
        from gpcsd_tpu import config

        config.set_policy(factor_dtype="float32", compute_dtype="float32",
                          spatial_precondition=True)
        try:
            model._fns_cache = {}
            fns = model._fns(precondition=True)
            Y = model._Y()
            u = fns.param_set.pack(model._theta())
            assert isinstance(fns.basis0, dict) and "qs" in fns.basis0
            b0 = jax.tree_util.tree_map(jnp.asarray, fns.basis0)
            lp1, b1 = fns.log_prob_basis(u, Y, b0)
            assert set(b1) == set(b0)
            nx = model.x.size
            qs = np.asarray(b1["qs"], np.float64)
            assert np.abs(qs.T @ qs - np.eye(nx)).max() < 5e-6
            # fixed point: re-evaluating from the returned bases agrees
            lp2, b2 = fns.log_prob_basis(u, Y, b1)
            np.testing.assert_allclose(float(lp2), float(lp1), rtol=1e-6)
            # bare-array (legacy) form still accepted and consistent
            lp3, qt3 = fns.log_prob_basis(u, Y, b0["qt"])
            np.testing.assert_allclose(float(lp3), float(lp1), rtol=1e-6)
        finally:
            config.set_policy(factor_dtype="float64", compute_dtype="float64",
                          spatial_precondition=False)
            model._fns_cache = {}

    def test_orth_polish_contracts_defect(self):
        q = _random_orthogonal(32, 7)
        q = q + 1e-3 * jnp.asarray(np.random.default_rng(8).normal(size=(32, 32)))
        d0 = float(jnp.linalg.norm(q.T @ q - jnp.eye(32)))
        q1 = kronlik.orth_polish(q)
        d1 = float(jnp.linalg.norm(q1.T @ q1 - jnp.eye(32)))
        assert d1 < 0.01 * d0


class TestWarmNUTS:
    def test_nuts_with_warm_basis_matches_plain(self, model):
        """Warm vs plain target the identical posterior: same-seed runs
        agree at the distribution level.  (Bitwise trajectory equality is
        NOT expected — the two routes differ at the 1e-13 rounding level and
        leapfrog dynamics amplify that chaotically.)"""
        from gpcsd_tpu.infer.nuts import nuts_chains

        fns = model._fns(precondition=True)
        Y = model._Y()
        key = jax.random.PRNGKey(0)
        u0s = jnp.stack([
            fns.param_set.clip_to_bounds(
                fns.param_set.pack(fns.param_set.sample(k))
            )
            for k in jax.random.split(key, 2)
        ])
        kw = dict(num_warmup=60, num_samples=60, max_depth=6)
        plain = nuts_chains(lambda u: fns.log_prob(u, Y), u0s, key, **kw)
        warm = nuts_chains(
            lambda u: fns.log_prob(u, Y), u0s, key,
            log_prob_aux=lambda u, qb: fns.log_prob_basis(u, Y, qb),
            aux0=jnp.asarray(fns.qt0), **kw,
        )
        assert np.isfinite(np.asarray(warm.samples)).all()
        assert float(np.mean(np.asarray(warm.diverging))) < 0.1
        assert float(np.mean(np.asarray(warm.accept_prob))) > 0.5
        # posterior log-density concentrates: the two runs' logp
        # distributions must overlap (within a few posterior SDs)
        lp_w, lp_p = np.asarray(warm.logp), np.asarray(plain.logp)
        tol = 4.0 * max(lp_w.std(), lp_p.std()) / np.sqrt(lp_w.size) + 1e-6
        assert abs(lp_w.mean() - lp_p.mean()) < 6.0 * tol

    def test_chunked_warm_matches_unchunked_warm(self, model):
        from gpcsd_tpu.infer.nuts import nuts_chains_chunked

        fns = model._fns(precondition=True)
        Y = model._Y()
        key = jax.random.PRNGKey(4)
        u0s = jnp.stack([
            fns.param_set.clip_to_bounds(
                fns.param_set.pack(fns.param_set.sample(k))
            )
            for k in jax.random.split(key, 2)
        ])
        kw = dict(num_warmup=25, num_samples=15, max_depth=5)
        warm_kw = dict(
            log_prob_aux=lambda u, qb: fns.log_prob_basis(u, Y, qb),
            aux0=jnp.asarray(fns.qt0),
        )
        r1 = nuts_chains_chunked(
            lambda u: fns.log_prob(u, Y), u0s, key, chunk_size=7, **kw, **warm_kw
        )
        assert np.isfinite(np.asarray(r1.samples)).all()
        assert r1.samples.shape == (2, 15, fns.param_set.dim)
