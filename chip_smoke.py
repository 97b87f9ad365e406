"""Smoke test of the GPCSD main path on one NVIDIA GPU.

Drives the model classes the way a user does — ``fit``, ``predict``,
``predict_variance``, ``predict_samples``, ``sample_posterior`` — at the
published auditory shape (nx=24, nt=600, 100 trials, ngl=100) and the
Neuropixels 2D shape (nx=69, nt=375, 100 trials, ngl 30x120), on data drawn
from ``--seed``, and checks every result against a reference:

- ``eval``: the executed reference's goldens (``tests/goldens``) recomputed
  on the card; the log-joint's value and gradient at 20 points per shape
  against CPU float64 JAX, which runs in a child process pinned to the CPU.
- ``noise``: RMS residual of a quadratic fit to the log-joint along a short
  segment (the method of ``scripts/f32_noise_probe.py``), card beside CPU.
- ``fit``: 10-restart MAP fit of a prior CSD draw pushed through the forward
  model, then posterior prediction; the predicted CSD must track the draw.
- ``nuts``: health-gated NUTS from the MAP with Laplace whitening.

Prints the device, the card's name and power limit and the numeric policy
first, one JSON line per result, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check, and a default JAX
device that is not a GPU, ends the run with a non-zero exit code and no
such line.

    python chip_smoke.py               # one card, all phases
    python chip_smoke.py --four-cards  # four cards: the sharded paths only
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

N_EVAL_POINTS = 20
EVAL_STEP = 0.01  # spread of the evaluation points in unconstrained units
VALUE_RTOL = 1e-9
GRAD_REL_L2 = 1e-6
# The 2D Neuropixels Ks spans 17 decades (||Ks|| ~4e10 down to the 1e-7
# jitter), so eigenvectors near the noise floor are fixed only to
# eps*||Ks||/gap: an eps-sized perturbation of Ks moves the log-joint by
# ~2e-6 relative on the CPU alone.  Measured errors: PERF.md.
TOLERANCES = {"1d": (VALUE_RTOL, GRAD_REL_L2), "2d": (2e-4, 2e-3)}
NOISE_POINTS = 41
NOISE_HALF_WIDTH = 1e-2
NOISE_GATE = 1e-3  # log-units of RMS evaluation noise
FIT_RESTARTS = 10
FIT_MIN_CORR = 0.95
# sharded and one-card values differ only in the order of the trial sum;
# gradients carry the 2D shape's conditioning, so they get its bound
SHARD_RTOL = 1e-10
# warmup = samples per chain of the four-card NUTS comparison: four cards
# cost four times as much per second, and the one-card run of the default
# phases already covers 100 + 100
FOUR_CARD_NUTS_STEPS = 50


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**fields):
    print(json.dumps(fields), flush=True)


def require_gpu(devices):
    """Refuse to run anywhere but on a GPU: no CPU fallback."""
    platform = devices[0].platform if devices else None
    check(platform == "gpu",
          f"JAX's default device is {platform!r}, not a GPU")


def require_checkout():
    """The package must come from the checkout that holds this script."""
    import gpcsd_tpu

    pkg = os.path.dirname(os.path.abspath(gpcsd_tpu.__file__))
    check(os.path.dirname(pkg) == ROOT,
          f"gpcsd_tpu imported from {pkg}, not from {ROOT}")


def peak_bytes(device):
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


# ---------------------------------------------------------------- numerics


def eval_points(m, n, seed):
    """``n`` distinct points around the model's current parameters."""
    fns = m._fns()
    u0 = np.asarray(fns.param_set.pack(m._theta()))
    rng = np.random.default_rng(seed)
    return u0[None] + EVAL_STEP * rng.normal(size=(n, u0.size))


def segment_points(m, seed, n=NOISE_POINTS, half_width=NOISE_HALF_WIDTH):
    """(ts, points): a straight segment through the current parameters
    along a random unit direction in unconstrained space."""
    fns = m._fns()
    u0 = np.asarray(fns.param_set.pack(m._theta()))
    du = np.random.default_rng(seed).normal(size=u0.size)
    du /= np.linalg.norm(du)
    ts = np.linspace(-half_width, half_width, n)
    return ts, u0[None] + ts[:, None] * du[None]


def noise_rms(ts, vals):
    """RMS residual of a quadratic fit: the evaluation noise of a locally
    smooth function sampled at ``ts``."""
    coef = np.polyfit(ts, vals, 2)
    return float(np.std(vals - np.polyval(coef, ts)))


def evaluate(m, pts, precondition=False, grad=True, passes=3):
    """Negative log-joint (and gradient) at ``pts`` through one jitted
    function.  Returns (values, grads or None, compile_s, evals_per_s);
    the rate is the median of ``passes`` (>= 1) timed sweeps over all
    points."""
    import jax
    import jax.numpy as jnp

    fns = m._fns(precondition=precondition)
    Y = m._Y()
    f = lambda u: fns.neg_log_joint(u, Y)  # noqa: E731
    fn = jax.jit(jax.value_and_grad(f) if grad else f)
    pts = jnp.asarray(pts)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(pts[0]))
    compile_s = time.perf_counter() - t0
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        outs = [fn(p) for p in pts]
        jax.block_until_ready(outs)
        rates.append(len(outs) / (time.perf_counter() - t0))
    if grad:
        vals = np.array([float(o[0]) for o in outs])
        grads = np.stack([np.asarray(o[1]) for o in outs])
    else:
        vals, grads = np.array([float(o) for o in outs]), None
    return vals, grads, compile_s, float(np.median(rates))


def compare(name, vals, ref_vals, grads=None, ref_grads=None,
            value_rtol=VALUE_RTOL, grad_rel_l2=GRAD_REL_L2):
    """Largest relative value error and relative L2 gradient error against
    the reference; raises :class:`SmokeFailure` beyond the bounds."""
    out = {"check": name, "points": int(len(vals)),
           "max_value_rel_err": float(np.max(np.abs(vals - ref_vals)
                                             / np.abs(ref_vals)))}
    if grads is not None:
        out["max_grad_rel_l2_err"] = float(np.max(
            np.linalg.norm(grads - ref_grads, axis=1)
            / np.linalg.norm(ref_grads, axis=1)))
    emit(**out)
    check(np.all(np.isfinite(vals)), f"{name}: non-finite values")
    check(out["max_value_rel_err"] <= value_rtol,
          f"{name}: value error {out['max_value_rel_err']:.3g} > {value_rtol}")
    if grads is not None:
        check(np.all(np.isfinite(grads)), f"{name}: non-finite gradients")
        check(out["max_grad_rel_l2_err"] <= grad_rel_l2,
              f"{name}: gradient error {out['max_grad_rel_l2_err']:.3g} "
              f"> {grad_rel_l2}")
    return out


# ----------------------------------------------------------------- problems


def build_problems(seed):
    """The eval and noise phases' models and points, all drawn from ``seed``
    so the CPU reference process rebuilds them identically."""
    import bench
    from scripts import bench_2d

    m1 = bench.build_problem(seed)
    m2 = bench_2d.build_problem(seed)
    mn = bench.build_nuts_problem(seed, het_noise="exact")
    ts, seg = segment_points(mn, seed)
    return {
        "1d": dict(m=m1, pts=eval_points(m1, N_EVAL_POINTS, seed)),
        "2d": dict(m=m2, pts=eval_points(m2, N_EVAL_POINTS, seed)),
        "noise": dict(m=mn, pts=seg, ts=ts, precondition=True, grad=False),
    }


def evaluate_problems(problems, passes=3):
    out = {}
    for name, p in problems.items():
        vals, grads, compile_s, rate = evaluate(
            p["m"], p["pts"], precondition=p.get("precondition", False),
            grad=p.get("grad", True), passes=passes,
        )
        out[name] = dict(vals=vals, grads=grads, compile_s=compile_s,
                         evals_per_s=rate)
    return out


def cpu_reference(seed, path):
    """Child-process entry: CPU float64 values of the eval/noise problems."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    check(jax.default_backend() == "cpu", "CPU reference is not on the CPU")
    res = evaluate_problems(build_problems(seed), passes=1)
    arrays = {}
    for name, r in res.items():
        arrays[name + "/vals"] = r["vals"]
        if r["grads"] is not None:
            arrays[name + "/grads"] = r["grads"]
    np.savez(path, **arrays)


def start_cpu_reference(seed, path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--cpu-reference", path],
        env=env, cwd=ROOT,
    )


# ------------------------------------------------------------------- phases


def phase_goldens():
    """The executed reference's recorded outputs, recomputed here."""
    sys.path.insert(0, os.path.join(ROOT, "tests", "goldens"))
    import reference_models as rm

    got = {
        "m1_loglik_hom": rm.model_1d().loglik(),
        "m1_loglik_het": rm.model_1d(het=True).loglik(),
        "m2_loglik": rm.model_2d().loglik(),
    }
    worst = 0.0
    for key, v in got.items():
        rel = abs(v - rm.SCAL[key]) / abs(rm.SCAL[key])
        worst = max(worst, rel)
        check(rel <= rm.LOGLIK_RTOL, f"golden {key}: rel error {rel:.3g}")
    m = rm.model_1d()
    rm.predict_1d(m)
    for key, get in rm.PREDICT_KEYS.items():
        ours = np.asarray(get(m), dtype=np.float64)
        ok = np.allclose(ours, rm.GOLD[key], rtol=rm.PREDICT_RTOL,
                         atol=rm.PREDICT_ATOL)
        check(ok, f"golden {key}: max abs error "
                  f"{np.max(np.abs(ours - rm.GOLD[key])):.3g}")
    emit(check="goldens", loglik_max_rel_err=worst,
         predict_keys=len(rm.PREDICT_KEYS))


def fit_drive(seed, nx=24, nt=600, ntrials=100, n_restarts=FIT_RESTARTS):
    """Prior CSD draw -> forward model -> noise -> fresh model: fit,
    predict, predict_variance and predict_samples at the electrodes."""
    import gpcsd_tpu as g
    from gpcsd_tpu.ops.forward import fwd_model_1d

    x = (np.arange(nx) * 100.0).reshape(-1, 1)
    t = np.arange(nt).reshape(-1, 1) * 1.0
    gen = g.GPCSD1D(np.zeros((nx, nt, 1)), x, t)
    gen.R["value"] = 150.0
    gen.spatial_cov.params["ell"]["value"] = 200.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 8.0
    gen.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    gen.temporal_cov_list[1].params["ell"]["value"] = 3.0
    gen.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    csd = gen.sample_prior(ntrials, seed=seed)
    lfp = np.array(np.moveaxis(np.asarray(fwd_model_1d(
        np.moveaxis(csd, 2, 0), x.ravel(), x.ravel(), 150.0)), 0, 2))
    lfp /= np.max(np.abs(lfp))
    # noiseless data would let the MAP collapse sig2n to 0
    lfp += 0.01 * np.random.default_rng(seed).normal(size=lfp.shape)
    m = g.GPCSD1D(lfp, x, t)
    t0 = time.perf_counter()
    m.fit(n_restarts=n_restarts, backend="jax", seed=seed)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = m.predict(x, t)
    var = m.predict_variance(x, t)
    draws = m.predict_samples(x, t, 10, seed=seed)
    predict_s = time.perf_counter() - t0
    for name, a in (("predict", pred), ("predict_variance", var),
                    ("predict_samples", draws)):
        check(np.all(np.isfinite(a)), f"{name}: non-finite output")
    check(pred.shape == csd.shape, f"predict shape {pred.shape}")
    check(var.shape == (nx, nt), f"predict_variance shape {var.shape}")
    check(draws.shape == (10, nx, nt), f"predict_samples shape {draws.shape}")
    corr = float(np.corrcoef(pred.ravel(), csd.ravel())[0, 1])
    return dict(fit_s=fit_s, predict_s=predict_s, corr=corr,
                nll=float(m.fit_result.nll_best))


def phase_nuts(seed, device):
    import jax
    import jax.numpy as jnp

    import bench

    nm = bench.build_nuts_problem(seed, het_noise="exact")
    t0 = time.perf_counter()
    bench.fit_nuts_problem(nm, seed=seed, n_restarts=FIT_RESTARTS)
    fit_s = time.perf_counter() - t0
    fns = nm._fns()
    Y = nm._Y()
    u_map = jnp.asarray(fns.param_set.pack(nm._theta()))
    t0 = time.perf_counter()
    H = np.asarray(jax.jit(jax.hessian(lambda u: fns.neg_log_joint(u, Y)))(u_map))
    hessian_s = time.perf_counter() - t0
    check(np.all(np.isfinite(H)), "AD Hessian at the MAP is not finite")
    _, st = bench.run_nuts(nm, seed=seed)
    emit(phase="nuts", fit_s=fit_s, ad_hessian_s=hessian_s, **st,
         peak_bytes=peak_bytes(device))
    check(not st["gate_failures"], f"NUTS health gates: {st['gate_failures']}")


def one_card(seed, tmpdir):
    import jax

    device = jax.devices()[0]
    ref_path = os.path.join(tmpdir, "cpu_reference.npz")
    child = start_cpu_reference(seed, ref_path)
    try:
        t0 = time.perf_counter()
        phase_goldens()
        problems = build_problems(seed)
        gpu = evaluate_problems(problems)
        for name in ("1d", "2d"):
            emit(phase="eval", shape=name, compile_s=gpu[name]["compile_s"],
                 evals_per_s=gpu[name]["evals_per_s"])
        emit(phase="eval", seconds=time.perf_counter() - t0,
             peak_bytes=peak_bytes(device))
        ts = problems["noise"]["ts"]
        gpu_noise = noise_rms(ts, gpu["noise"]["vals"])
        emit(phase="noise", gpu_rms=gpu_noise, gate=NOISE_GATE,
             peak_bytes=peak_bytes(device))
        check(gpu_noise <= NOISE_GATE,
              f"evaluation noise {gpu_noise:.3g} > {NOISE_GATE}")

        fit = fit_drive(seed)
        emit(phase="fit", **fit, peak_bytes=peak_bytes(device))
        check(fit["corr"] > FIT_MIN_CORR,
              f"predicted CSD correlation {fit['corr']:.4f} <= {FIT_MIN_CORR}")

        phase_nuts(seed, device)

        check(child.wait() == 0, "CPU reference process failed")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with np.load(ref_path) as ref:
        for name in ("1d", "2d"):
            value_rtol, grad_rel_l2 = TOLERANCES[name]
            compare(f"eval {name} vs CPU f64", gpu[name]["vals"],
                    ref[name + "/vals"], gpu[name]["grads"],
                    ref[name + "/grads"], value_rtol=value_rtol,
                    grad_rel_l2=grad_rel_l2)
        compare("noise segment vs CPU f64", gpu["noise"]["vals"],
                ref["noise/vals"])
        emit(phase="noise", gpu_rms=gpu_noise,
             cpu_f64_rms=noise_rms(ts, ref["noise/vals"]))


def four_cards(seed):
    """Trial-sharded value+grad at the 2D shape on a (chain=1, trial=4)
    mesh against the same call on one card, and 4-chain NUTS on a
    (chain=4) mesh against the vmapped chains on one card, on the auditory
    surrogate with one shared noise variance."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from scripts import bench_2d
    from gpcsd_tpu.parallel.mesh import make_mesh
    from gpcsd_tpu.parallel.sharded import make_trial_sharded_log_prob

    devices = jax.devices()
    check(len(devices) == 4, f"--four-cards needs 4 GPUs, found {len(devices)}")

    m = bench_2d.build_problem(seed)
    fns = m._fns()
    Y = np.asarray(m._Y())
    pts = jnp.asarray(eval_points(m, 5, seed))
    res = {}
    for label, mesh in (("4 cards", make_mesh(chain=1, trial=4)),
                        ("1 card", make_mesh(chain=1, trial=1,
                                             devices=devices[:1]))):
        lp = make_trial_sharded_log_prob(fns, Y.shape[0])

        @jax.jit
        @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("trial")),
                 out_specs=(P(), P()))
        def vg(u, Y_local, lp=lp):
            return jax.value_and_grad(lambda v: lp(v, Y_local))(u)

        Ys = jax.device_put(jnp.asarray(Y), NamedSharding(mesh, P("trial")))
        t0 = time.perf_counter()
        jax.block_until_ready(vg(pts[0], Ys))
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = [vg(p, Ys) for p in pts]
        jax.block_until_ready(outs)
        rate = len(outs) / (time.perf_counter() - t0)
        res[label] = (np.array([float(o[0]) for o in outs]),
                      np.stack([np.asarray(o[1]) for o in outs]))
        emit(phase="sharded value+grad", mesh=label, compile_s=compile_s,
             evals_per_s=rate)
    (v4, g4), (v1, g1) = res["4 cards"], res["1 card"]
    compare("trial-sharded vs one card", v4, v1, g4, g1,
            value_rtol=SHARD_RTOL, grad_rel_l2=TOLERANCES["2d"][1])

    # chains start at the surrogate's generating parameters (no MAP fit:
    # it is the one-card path, checked by the default run)
    nm = bench.build_nuts_problem(seed)
    failures = {}
    for label, mesh in (("4 cards, chain mesh", make_mesh(chain=4)),
                        ("1 card, vmapped chains", None)):
        _, st = bench.run_nuts(nm, mesh=mesh, seed=seed,
                               num_warmup=FOUR_CARD_NUTS_STEPS,
                               num_samples=FOUR_CARD_NUTS_STEPS)
        emit(phase="nuts", mesh=label, **st,
             peak_bytes=[peak_bytes(d) for d in devices])
        failures[label] = st["gate_failures"]
    for label, f in failures.items():
        check(not f, f"NUTS ({label}) health gates: {f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded checks")
    ap.add_argument("--cpu-reference", metavar="PATH",
                    help=argparse.SUPPRESS)  # child-process entry
    args = ap.parse_args(argv)
    if args.cpu_reference:
        cpu_reference(args.seed, args.cpu_reference)
        return 0

    require_checkout()
    import jax

    from gpcsd_tpu import config

    devices = jax.devices()
    require_gpu(devices)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    pol = config.get_policy()
    print(f"devices: platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)}")
    print(smi)
    print(f"policy: factor_dtype={np.dtype(pol.resolve_factor_dtype()).name} "
          f"compute_dtype={np.dtype(pol.resolve_compute_dtype()).name} "
          f"jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision}", flush=True)

    if args.four_cards:
        four_cards(args.seed)
    else:
        with tempfile.TemporaryDirectory() as tmpdir:
            one_card(args.seed, tmpdir)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
