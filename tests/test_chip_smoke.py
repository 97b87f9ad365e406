"""chip_smoke.py's checks, at tiny shapes on the CPU.

The script itself runs only on a GPU; what it compares and how it decides
are tested here.  ``TestOnCard`` runs the script where a card is present.
"""

import importlib.util
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")

spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)


def _tiny_model(seed=0):
    import gpcsd_tpu as g

    rng = np.random.default_rng(seed)
    x = (np.arange(5) * 100.0).reshape(-1, 1)
    t = np.arange(9).reshape(-1, 1) * 1.0
    m = g.GPCSD1D(rng.normal(size=(5, 9, 3)), x, t, ngl=12)
    m.R["value"] = 120.0
    m.spatial_cov.params["ell"]["value"] = 150.0
    for tc, (ell, s2) in zip(m.temporal_cov_list, ((3.0, 1.0), (1.0, 0.5))):
        tc.params["ell"]["value"] = ell
        tc.params["sigma2"]["value"] = s2
    m.sig2n["value"] = 0.1
    return m


def _run_alone(workdir, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run(
        [sys.executable, os.path.join(workdir, "chip_smoke.py")],
        cwd=workdir, env=env, capture_output=True, text=True, timeout=300,
    )


class TestReferenceComparison:
    def test_goldens_match_on_cpu(self):
        cs.phase_goldens()  # raises SmokeFailure on any mismatch

    def test_compare_bounds(self):
        vals = np.array([1.0e6, -2.0e5])
        grads = np.array([[1.0, 2.0], [3.0, -4.0]])
        out = cs.compare("same", vals, vals.copy(), grads, grads.copy())
        assert out["max_value_rel_err"] == 0.0
        with pytest.raises(cs.SmokeFailure, match="value error"):
            cs.compare("off", vals * (1 + 1e-8), vals, grads, grads)
        with pytest.raises(cs.SmokeFailure, match="gradient error"):
            cs.compare("off", vals, vals, grads * (1 + 1e-5), grads)
        with pytest.raises(cs.SmokeFailure, match="non-finite"):
            cs.compare("nan", np.array([np.nan, 1.0]), np.array([1.0, 1.0]))

    def test_evaluate_matches_direct_calls(self):
        import jax

        m = _tiny_model()
        pts = cs.eval_points(m, 3, seed=1)
        vals, grads, compile_s, rate = cs.evaluate(m, pts, passes=1)
        fns = m._fns()
        for p, v, gr in zip(pts, vals, grads):
            f, g = jax.value_and_grad(fns.neg_log_joint)(p, m._Y())
            np.testing.assert_allclose(v, float(f), rtol=1e-12)
            np.testing.assert_allclose(gr, np.asarray(g), rtol=1e-10)
        assert compile_s > 0 and rate > 0


class TestNoiseProbe:
    def test_quadratic_fit_residual(self):
        ts = np.linspace(-1e-2, 1e-2, 41)
        smooth = 3.0 + 50.0 * ts - 2.0e4 * ts**2
        assert cs.noise_rms(ts, smooth) < 1e-9
        jitter = 1e-3 * np.random.default_rng(0).normal(size=ts.size)
        assert 0.5e-3 < cs.noise_rms(ts, smooth + jitter) < 1.5e-3

    def test_segment_is_centered_and_straight(self):
        m = _tiny_model()
        ts, pts = cs.segment_points(m, seed=3, n=11, half_width=1e-2)
        u0 = np.asarray(m._fns().param_set.pack(m._theta()))
        np.testing.assert_allclose(pts[5], u0)
        step = np.diff(pts, axis=0)
        np.testing.assert_allclose(step, np.broadcast_to(step[0], step.shape))
        assert np.isclose(np.linalg.norm(pts[-1] - pts[0]), 2e-2)


class TestRefusesWithoutCard:
    def test_require_gpu(self):
        dev = lambda p: types.SimpleNamespace(platform=p)  # noqa: E731
        for devices in ([dev("cpu")], [], [dev("cuda")]):
            with pytest.raises(cs.SmokeFailure, match="not a GPU"):
                cs.require_gpu(devices)
        cs.require_gpu([dev("gpu")])

    def test_cpu_run_exits_nonzero(self):
        r = _run_alone(ROOT, {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "not a GPU" in r.stderr

    def test_script_alone_exits_nonzero(self, tmp_path):
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        r = _run_alone(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


@pytest.fixture
def gpu_card():
    """Skip unless the machine has an NVIDIA card (the test processes
    themselves are pinned to the CPU, so the check runs in a child)."""
    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run(
        [smi, "-L"], capture_output=True, text=True).stdout.strip()
    if not listed:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
class TestOnCard:
    def test_chip_smoke_passes(self, gpu_card):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        r = subprocess.run([sys.executable, SCRIPT], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-4000:]
        assert r.stdout.strip().splitlines()[-1].startswith('{"ok": true')
