"""Jacobi eigensolver correctness (vs LAPACK) and schedule coverage."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpcsd_tpu.ops.jacobi import (
    _initial_layout,
    _step_permutation,
    eigh_jacobi,
)


class TestSchedule:
    def test_round_robin_covers_all_pairs(self):
        """Following the circle layout through n-1 permutation steps must
        pivot every unordered pair exactly once."""
        n = 10
        L = list(_initial_layout(n))
        sigma = _step_permutation(n)
        seen = set()
        for _ in range(n - 1):
            for i in range(n // 2):
                seen.add(tuple(sorted((L[2 * i], L[2 * i + 1]))))
            L = [L[s] for s in sigma]
        assert len(seen) == n * (n - 1) // 2
        # and the layout returns to the start
        assert L == list(_initial_layout(n))


class TestEighJacobi:
    @pytest.mark.parametrize("n", [2, 8, 17, 64, 101])
    def test_matches_lapack(self, rng, n):
        A = rng.normal(size=(n, n))
        A = 0.5 * (A + A.T)
        w, V = eigh_jacobi(jnp.asarray(A))
        wr = np.linalg.eigh(A)[0]
        assert np.allclose(np.asarray(w), wr, rtol=1e-10, atol=1e-10)
        recon = np.asarray(V) @ np.diag(np.asarray(w)) @ np.asarray(V).T
        assert np.allclose(recon, A, atol=1e-10)
        # orthonormal eigenvectors
        assert np.allclose(np.asarray(V).T @ np.asarray(V), np.eye(n), atol=1e-10)

    def test_tiny_eigenvalues_relative_accuracy(self, rng):
        """Graded spectrum spanning 12 orders of magnitude."""
        n = 32
        d = 10.0 ** np.linspace(-12, 0, n)
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        A = Q @ np.diag(d) @ Q.T
        w, _ = eigh_jacobi(jnp.asarray(A))
        wr = np.linalg.eigh(A)[0]
        assert np.allclose(np.asarray(w), wr, rtol=1e-6, atol=1e-14)

    def test_slices_method_graded_spd(self, rng):
        """Explicit ``method='slices'`` parity on a graded SPD matrix (14
        decades of spectrum, like the spatial quadrature Gram)."""
        n = 48
        d = 10.0 ** np.linspace(-14, 0, n)
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        A = Q @ np.diag(d) @ Q.T
        w, V = eigh_jacobi(jnp.asarray(A), method="slices")
        wr = np.linalg.eigh(A)[0]
        assert np.allclose(np.sort(np.asarray(w)), wr, rtol=1e-6, atol=1e-15)
        V = np.asarray(V)
        assert np.abs(V.T @ V - np.eye(n)).max() < 1e-10

    def test_accelerator_small_f64_routing_parity(self, rng, monkeypatch):
        """No backend is routed to the Jacobi solvers any more: with the
        backend reported as a GPU, ``kronlik.eigh_safe`` on a small graded
        f64 matrix is exactly ``jnp.linalg.eigh`` and matches NumPy, and
        ``eigh_jacobi``'s default method is ``slices``."""
        from gpcsd_tpu.ops import kronlik

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        n = 24
        d = 10.0 ** np.linspace(-13, 0, n)
        Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
        A = jnp.asarray(Q @ np.diag(d) @ Q.T, jnp.float64)
        w, V = kronlik.eigh_safe(A)
        w_ref, V_ref = jnp.linalg.eigh(A)
        np.testing.assert_array_equal(np.asarray(w), np.asarray(w_ref))
        np.testing.assert_array_equal(np.asarray(V), np.asarray(V_ref))
        wr = np.linalg.eigh(np.asarray(A))[0]
        assert np.allclose(np.asarray(w), wr, rtol=1e-5, atol=1e-13)
        np.testing.assert_array_equal(
            np.asarray(eigh_jacobi(A)[0]),
            np.asarray(eigh_jacobi(A, method="slices")[0]),
        )

    def test_vmap_batched(self, rng):
        As = rng.normal(size=(3, 16, 16))
        As = 0.5 * (As + np.swapaxes(As, 1, 2))
        w, V = jax.vmap(eigh_jacobi)(jnp.asarray(As))
        for b in range(3):
            assert np.allclose(np.asarray(w[b]), np.linalg.eigh(As[b])[0], atol=1e-10)

    def test_in_likelihood_path(self, rng):
        """eigh_safe dispatch keeps the marginal likelihood exact on CPU."""
        from gpcsd_tpu.ops import kronlik

        A = rng.normal(size=(6, 6))
        Ks = A @ A.T + 6 * np.eye(6)
        B = rng.normal(size=(9, 9))
        Kt = B @ B.T + 9 * np.eye(9)
        Y = rng.normal(size=(2, 6, 9))
        fac = kronlik.comp_eig_d(jnp.asarray(Ks), jnp.asarray(Kt), 0.3)
        got = float(kronlik.loglik(fac, jnp.asarray(Y)))
        dense = np.kron(Ks, Kt) + 0.3 * np.eye(54)
        _, logdet = np.linalg.slogdet(dense)
        inv = np.linalg.inv(dense)
        want = sum(
            -0.5 * logdet - 0.5 * Y[b].reshape(-1) @ inv @ Y[b].reshape(-1)
            for b in range(2)
        )
        assert np.allclose(got, want, rtol=1e-8)
