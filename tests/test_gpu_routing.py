"""The GPU takes the CPU's code path.

Each test reports the backend as a GPU and checks that the numeric policy,
the factorization, the model functions and the inference drivers come out
exactly as on the CPU: float64, ``jnp.linalg.eigh``, no DCT basis, no warm
basis, the AD Hessian, and one jitted program for NUTS and L-BFGS.  Plus
where JAX's persistent compilation cache lives.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gpcsd_tpu as g
from gpcsd_tpu import config
from gpcsd_tpu.ops import kronlik

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def as_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _small_model(nt=10, seed=0):
    rng = np.random.default_rng(seed)
    nx, ntrials = 6, 4
    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    m = g.GPCSD1D(0.5 * rng.normal(size=(nx, nt, ntrials)), x, t, ngl=20)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 180.0
    m.temporal_cov_list[0].params["ell"]["value"] = 4.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 0.5
    m.temporal_cov_list[1].params["ell"]["value"] = 1.5
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.3
    m.sig2n["value"] = 0.1
    return m


class TestNumericPolicy:
    def test_float64_on_gpu(self, as_gpu):
        pol = config.Policy()
        assert pol.resolve_factor_dtype() == jnp.float64
        assert pol.resolve_compute_dtype() == jnp.float64
        # the float32 mixed path stays reachable by explicit request
        f32 = config.Policy(factor_dtype=jnp.dtype("float32"))
        assert f32.resolve_factor_dtype() == jnp.float32


class TestFactorization:
    @pytest.mark.parametrize("n", [24, 300])
    def test_same_factors_as_cpu(self, rng, monkeypatch, n):
        """Below and above the old Jacobi threshold (n >= 257) the GPU
        factors Kt with the same ``eigh`` as the CPU."""
        t = np.arange(n, dtype=float)
        dt = t[:, None] - t[None, :]
        Kt = jnp.asarray(np.exp(-0.5 * (dt / 8.0) ** 2)
                         + 0.5 * np.exp(-np.abs(dt) / 3.0))
        A = rng.normal(size=(6, 6))
        Ks = jnp.asarray(A @ A.T + 6 * np.eye(6))
        cpu = kronlik.comp_eig_d(Ks, Kt, 0.05)
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        gpu = kronlik.comp_eig_d(Ks, Kt, 0.05)
        for a, b in zip(cpu, gpu):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        w, v = jnp.linalg.eigh(Kt)
        np.testing.assert_array_equal(np.asarray(gpu.qt), np.asarray(v))

    def test_no_dct_basis_on_uniform_grid(self, as_gpu):
        """A long uniform time grid no longer gets the DCT preconditioning
        basis: the unpreconditioned model functions factor Kt directly."""
        m = _small_model(nt=260)
        fns = m._fns()
        np.testing.assert_array_equal(np.asarray(fns.qt0), np.eye(260))
        th = m._theta()
        want = kronlik.loglik(
            kronlik.comp_eig_d(fns.build_ks(th), fns.build_kt(th),
                               th["sig2n"]),
            m._Y(),
        )
        assert float(fns.loglik(th, m._Y())) == float(want)


class TestInferenceDrivers:
    def test_nuts_one_program_no_warm_basis_ad_hessian(self, as_gpu,
                                                       monkeypatch):
        """sample_posterior with default options: the AD Hessian for the
        Laplace whitening, no basis threading, one jitted NUTS program."""
        from gpcsd_tpu.infer import nuts

        calls = {"hessian": 0, "aux": []}
        real_hessian, real_chains = jax.hessian, nuts.nuts_chains

        def spy_hessian(f):
            calls["hessian"] += 1
            return real_hessian(f)

        def spy_chains(*a, **kw):
            calls["aux"].append(kw.get("log_prob_aux"))
            return real_chains(*a, **kw)

        def no_chunks(*a, **kw):
            raise AssertionError("chunked NUTS driver used by default")

        monkeypatch.setattr(jax, "hessian", spy_hessian)
        monkeypatch.setattr(nuts, "nuts_chains", spy_chains)
        monkeypatch.setattr(nuts, "nuts_chains_chunked", no_chunks)
        post = _small_model().sample_posterior(
            n_chains=2, num_warmup=10, num_samples=5, max_depth=4)
        assert calls["hessian"] == 1
        assert calls["aux"] == [None]
        assert np.isfinite(post.theta["R"]).all()

    def test_map_fit_one_program(self, as_gpu, monkeypatch):
        """fit() runs the vmapped L-BFGS as one program unless chunking is
        asked for."""
        from gpcsd_tpu.infer import lbfgs

        def no_chunks(*a, **kw):
            raise AssertionError("chunked L-BFGS driver used by default")

        monkeypatch.setattr(lbfgs, "lbfgs_minimize_chunked", no_chunks)
        m = _small_model()
        res = m.fit(n_restarts=2, options={"maxiter": 20})
        assert np.isfinite(res.nll_best)
        with pytest.raises(AssertionError, match="chunked"):
            m.fit(n_restarts=2, options={"maxiter": 20, "chunk_iters": 3})


def _cache_dir_in_subprocess(env):
    code = ("import gpcsd_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


class TestCompileCache:
    @pytest.mark.parametrize("case", ["env set", "env unset", "cpu only"])
    def test_placement(self, tmp_path, case):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = ROOT
        if case == "env set":
            env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
            want = str(tmp_path)
        elif case == "env unset":
            want = os.path.join(ROOT, ".jax_cache")
        else:
            env["JAX_PLATFORMS"] = "cpu"
            want = None
        assert config.compile_cache_dir(env) == want
        assert _cache_dir_in_subprocess(env) == str(want)
