"""Mixed-precision factor path (`kronlik.eigh_mixed`, `_factor_eigh`).

The explicit float32 factor policy's accuracy fix: a pure-f32 factor
policy carries ~2 RMS log-units of evaluation noise at the auditory
problem size, enough to collapse NUTS step sizes.  The mixed path keeps
covariances and the spectrum in float64 (double-f32 products) with
f32-stored eigenvectors; these tests pin its accuracy contract on CPU
where the float64 control is exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gpcsd_tpu import config
from gpcsd_tpu.ops import kronlik


@pytest.fixture
def f32_policy():
    config.set_policy(factor_dtype="float32", compute_dtype="float32")
    yield
    config.set_policy(factor_dtype="float64", compute_dtype="float64")


def _se_matern(n=400):
    t = np.arange(float(n))[:, None]
    dt = t - t.T
    return 0.35 * np.exp(-0.5 * (dt / 40.0) ** 2) + 0.15 * np.exp(
        -np.abs(dt) / 5.0
    )


class TestEighMixed:
    def test_accuracy_vs_f64(self):
        K = _se_matern(400)
        w64, _ = np.linalg.eigh(K)
        w, v = kronlik.eigh_mixed(jnp.asarray(K))
        w = np.sort(np.asarray(w))
        v = np.asarray(v, np.float64)
        assert v.dtype == np.float64 and np.asarray(w).dtype == np.float64
        # eigenvalues: high RELATIVE accuracy over the resolvable spectrum
        m = w64 > 1e-6 * w64.max()
        assert np.max(np.abs(w[m] - w64[m]) / w64[m]) < 2e-3
        # orthogonality at the f32 rounding floor
        assert np.abs(v.T @ v - np.eye(K.shape[0])).max() < 5e-6

    def test_f32_rotation_build_matches_contract(self):
        """Rotation angles built in f32 must preserve the eigenvalue
        accuracy contract: the angles only materialize as the f32
        ``w_rot`` anyway; eigenvalues come from the double-f32-tracked
        congruence either way, and the gap is differenced in f64 before
        the cast."""
        K = _se_matern(400)
        w64, _ = np.linalg.eigh(K)
        old = kronlik.EIGH_MIXED_F32_ROTATIONS
        try:
            kronlik.EIGH_MIXED_F32_ROTATIONS = True
            w, v = kronlik._eigh_mixed_impl(jnp.asarray(K))
        finally:
            kronlik.EIGH_MIXED_F32_ROTATIONS = old
        w = np.sort(np.asarray(w))
        v = np.asarray(v, np.float64)
        m = w64 > 1e-6 * w64.max()
        assert np.max(np.abs(w[m] - w64[m]) / w64[m]) < 2e-3
        assert np.abs(v.T @ v - np.eye(K.shape[0])).max() < 5e-6

    def test_f32_rotation_graded_spectrum(self):
        """f32 angles on a strongly GRADED spectrum (the spatial-Gram
        regime, 10+ decades): relative eigenvalue accuracy must survive
        for every resolvable mode — small off-diagonals keep ~7 digits of
        their OWN mantissa in f32, so the rotations they generate are
        equally accurate."""
        rng = np.random.default_rng(3)
        n = 96
        q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        lam = np.logspace(0, -12, n)
        K = (q * lam) @ q.T
        K = 0.5 * (K + K.T)
        w64 = np.sort(np.linalg.eigh(K)[0])
        old = kronlik.EIGH_MIXED_F32_ROTATIONS
        try:
            kronlik.EIGH_MIXED_F32_ROTATIONS = True
            w_f32rot, _ = kronlik._eigh_mixed_impl(jnp.asarray(K))
        finally:
            kronlik.EIGH_MIXED_F32_ROTATIONS = old
        w_f64rot, _ = kronlik._eigh_mixed_impl(jnp.asarray(K))
        w_f32rot = np.sort(np.asarray(w_f32rot))
        w_f64rot = np.sort(np.asarray(w_f64rot))
        # the residual error of this family is set by the f32-EIGH START's
        # basis resolution (identical for both variants); the rotation
        # precision itself must contribute nothing measurable on top
        m = w64 > 1e-6 * w64.max()
        rel = lambda w: np.max(np.abs(w[m] - w64[m]) / np.abs(w64[m]))
        assert rel(w_f32rot) < 1.05 * rel(w_f64rot) + 1e-7
        # and over the well-resolved modes the contract holds outright
        m4 = w64 > 1e-4 * w64.max()
        assert np.max(np.abs(w_f32rot[m4] - w64[m4]) / w64[m4]) < 1e-5

    @pytest.mark.parametrize("n", [2, 5, 8, 24, 37])
    def test_roundrobin_mask_family(self, n):
        """Closed-form circle-method rounds: each round is a disjoint
        symmetric pairing, and the family covers every index pair exactly
        once per cycle."""
        n_rounds = kronlik.ROUNDROBIN_N_ROUNDS(n)
        seen = np.zeros((n, n), int)
        for r in range(n_rounds):
            m = np.asarray(kronlik._roundrobin_mask(r, n))
            assert m.dtype == bool and (m == m.T).all()
            assert not m.diagonal().any()
            # disjoint: each index in at most one pair
            assert m.sum(axis=1).max() <= 1
            seen += m
        off = ~np.eye(n, dtype=bool)
        assert (seen[off] == 1).all(), "pair not covered exactly once"

    def test_identity_start_far_from_center(self):
        """ADVICE r3 medium: the identity-start refinement must converge —
        not silently return the diagonal of an under-diagonalized matrix —
        when the congruence is NOT near-diagonal (NUTS tail/divergence
        evaluations, SMC tempering).  The graded spatial quadrature Gram in
        a basis from a 2-3x-different length scale is the worst case the
        sampler actually produces."""
        from scipy.special import roots_legendre

        def ks_gram(ell, nx=24, ngl=100):
            x = np.arange(nx) * 100.0
            glx, glw = roots_legendre(ngl)
            a, b = x.min(), x.max()
            gl_x = 0.5 * (glx + 1) * (b - a) + a
            gl_w = 0.5 * (b - a) * glw
            u = (x[:, None] - gl_x[None, :]) / 150.0
            A = gl_w[None, :] * (np.sqrt(u * u + 1) - np.abs(u))
            Kgl = np.exp(-0.5 * ((gl_x[:, None] - gl_x[None, :]) / ell) ** 2)
            return A @ Kgl @ A.T + 1e-8 * np.eye(nx)

        _, q0 = np.linalg.eigh(ks_gram(200.0))  # center basis
        for ell_far in (210.0, 400.0, 600.0, 60.0):
            K = ks_gram(ell_far)
            wt = np.sort(np.linalg.eigh(K)[0])
            w, v = kronlik._eigh_mixed_b(jnp.asarray(q0.T @ K @ q0))
            w = np.sort(np.maximum(np.asarray(w), 0.0))
            m = wt > 1e-10 * wt.max()
            rel = np.max(np.abs(w[m] - wt[m]) / wt[m])
            assert rel < 1e-5, (ell_far, rel)  # old fixed schedule: up to 1e2
            vv = np.asarray(v, np.float64)
            assert np.abs(vv.T @ vv - np.eye(24)).max() < 5e-6

    def test_identity_start_batched(self):
        """The adaptive while_loop must work under vmap (NUTS vmaps chains):
        batch elements at different distances from diagonal all converge."""
        K1 = _se_matern(48)
        w1 = np.linalg.eigh(K1)[0]
        _, qc = np.linalg.eigh(_se_matern(48) + 0.3 * np.eye(48))
        B_near = np.diag(np.linspace(1.0, 2.0, 48))  # already diagonal
        B_far = qc.T @ K1 @ qc
        batch = jnp.stack([jnp.asarray(B_near), jnp.asarray(B_far)])
        w, v = jax.vmap(kronlik._eigh_mixed_b)(batch)
        assert np.allclose(np.sort(np.asarray(w[0])), np.linspace(1, 2, 48))
        got = np.sort(np.asarray(w[1]))
        wt = np.sort(w1)
        m = wt > 1e-10 * wt.max()
        assert np.max(np.abs(got[m] - wt[m]) / wt[m]) < 1e-5

    def test_grad_flows(self):
        K = _se_matern(64)

        def f(s):
            w, v = kronlik.eigh_mixed(jnp.asarray(K) * s)
            return jnp.sum(jnp.log(jnp.maximum(w, 1e-12)))

        g = jax.grad(f)(1.0)
        # d/ds sum(log(s*w)) = n/s
        assert np.isfinite(float(g))
        assert abs(float(g) - 64.0) < 1e-3


class TestMixedFactorLoglik:
    def test_loglik_close_to_f64(self, f32_policy):
        """Mixed-policy factors reproduce the f64 likelihood to <0.5
        log-units on a graded problem (vs O(10) for the old pure-f32
        policy at scale)."""
        rng = np.random.default_rng(0)
        nx, nt, ntr = 16, 300, 8
        # graded spatial Gram: 10+ decades like the quadrature Ks
        q, _ = np.linalg.qr(rng.normal(size=(nx, nx)))
        lam = 10.0 ** np.linspace(6, -7, nx)
        Ks = (q * lam) @ q.T
        Ks = 0.5 * (Ks + Ks.T)
        Kt = _se_matern(nt)
        Y = rng.normal(size=(ntr, nx, nt))
        sig2n = 0.05

        fac = kronlik.comp_eig_d(Ks, Kt, jnp.asarray(sig2n))
        ll_mixed = float(kronlik.loglik(fac, jnp.asarray(Y)))
        assert fac.qt.dtype == jnp.float32
        assert fac.d.dtype == jnp.float64

        config.set_policy(factor_dtype="float64", compute_dtype="float64")
        fac64 = kronlik.comp_eig_d(Ks, Kt, jnp.asarray(sig2n))
        ll64 = float(kronlik.loglik(fac64, jnp.asarray(Y)))
        assert abs(ll_mixed - ll64) < 0.5

    def test_preconditioned_spatial_basis(self, f32_policy):
        """comp_eig_d_preconditioned with a spatial preconditioning basis
        (q0s) agrees with the direct mixed factorization on a graded
        spatial Gram — the sampler hot-path configuration."""
        rng = np.random.default_rng(2)
        nx, nt, ntr = 12, 300, 4
        q, _ = np.linalg.qr(rng.normal(size=(nx, nx)))
        lam = 10.0 ** np.linspace(5, -6, nx)
        Ks0 = 0.5 * ((q * lam) @ q.T + ((q * lam) @ q.T).T)
        Ks = 1.07 * Ks0  # the sampler evaluates NEAR the center, not at it
        Kt = _se_matern(nt)
        Kt0 = 1.1 * _se_matern(nt)
        Y = rng.normal(size=(ntr, nx, nt))
        w0t, q0t = np.linalg.eigh(Kt0)
        w0s, q0s = np.linalg.eigh(Ks0)
        fac_p = kronlik.comp_eig_d_preconditioned(
            Ks, Kt, jnp.asarray(0.05), jnp.asarray(q0t), q0s=jnp.asarray(q0s)
        )
        assert fac_p.d.dtype == jnp.float64
        fac_d = kronlik.comp_eig_d(Ks, Kt, jnp.asarray(0.05))
        ll_p = float(kronlik.loglik(fac_p, jnp.asarray(Y)))
        ll_d = float(kronlik.loglik(fac_d, jnp.asarray(Y)))
        assert abs(ll_p - ll_d) < 0.5

    def test_preconditioned_matches(self, f32_policy):
        """The preconditioned mixed branch agrees with the direct mixed
        factorization's likelihood (same identity, different basis)."""
        rng = np.random.default_rng(1)
        nx, nt, ntr = 8, 300, 4
        q, _ = np.linalg.qr(rng.normal(size=(nx, nx)))
        lam = 10.0 ** np.linspace(4, -5, nx)
        Ks = 0.5 * ((q * lam) @ q.T + ((q * lam) @ q.T).T)
        Kt = _se_matern(nt)
        Y = rng.normal(size=(ntr, nx, nt))
        # center basis from a NEARBY kernel (the sampler's situation)
        Kt0 = 1.1 * _se_matern(nt)
        w0, q0 = np.linalg.eigh(Kt0)
        fac_p = kronlik.comp_eig_d_preconditioned(
            Ks, Kt, jnp.asarray(0.05), jnp.asarray(q0)
        )
        fac_d = kronlik.comp_eig_d(Ks, Kt, jnp.asarray(0.05))
        ll_p = float(kronlik.loglik(fac_p, jnp.asarray(Y)))
        ll_d = float(kronlik.loglik(fac_d, jnp.asarray(Y)))
        assert abs(ll_p - ll_d) < 0.5
