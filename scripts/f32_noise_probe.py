"""Measure the small-scale noise of the accelerator log-joint.

NUTS acceptance needs the Hamiltonian resolved to O(1): if the f32
log-density has evaluation noise of many log-units at leapfrog step
scales, dual averaging collapses the step size to ~1e-10 (observed on
both paper-run attempts: round 2 and round 3 first try).  This probe
quantifies that noise on the PAPER model (cached surrogate + fitted MAP
from results/paper_nuts): evaluate logp along a tiny whitened line
segment on the accelerator, fit a quadratic (the truth is locally
smooth), and report the RMS residual = evaluation noise.  Run with
--cpu for the float64 control.

Usage:  python scripts/f32_noise_probe.py [--cpu] [--scale 1e-2]
"""

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="force the float32 factor/compute policy")
    ap.add_argument("--out-dir", default="results/paper_nuts")
    ap.add_argument("--scale", type=float, default=1e-2,
                    help="half-width of the probed segment in unconstrained "
                         "log-units (leapfrog steps move ~1e-2..1e-1)")
    ap.add_argument("--npts", type=int, default=33)
    ap.add_argument("--temporal-identity-start", action="store_true",
                    help="probe the opt-in identity-start temporal "
                         "refinement (config.Policy.temporal_identity_start)")
    ap.add_argument("--no-identity-start", action="store_true",
                    help="force temporal_identity_start=False (f32-eigh "
                         "start) — isolates the identity-start stage")
    ap.add_argument("--exact-track", action="store_true",
                    help="round-4 exact double-f32 congruence tracking "
                         "through every sweep (kronlik.EIGH_MIXED_EXACT_"
                         "TRACK) instead of f32-tracked + one exact end "
                         "spectrum")
    ap.add_argument("--reps", type=int, default=None,
                    help="override kronlik.EIGH_MIXED_REPS sweep "
                         "repetitions")
    ap.add_argument("--f64-factors", action="store_true",
                    help="force factor_dtype=float64 (the default)")
    ap.add_argument("--f64-compute", action="store_true",
                    help="force compute_dtype=float64 (the whiten/quad "
                         "trial contraction) — isolates the MXU "
                         "contraction stage")
    ap.add_argument("--het-exact", action="store_true",
                    help="build the model with het_noise='exact' (the "
                         "round-5 production paper-run configuration)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    if args.f32:
        from gpcsd_tpu import config
        config.set_policy(factor_dtype="float32", compute_dtype="float32")
    if args.temporal_identity_start:
        from gpcsd_tpu import config
        config.set_policy(temporal_identity_start=True)
    if args.no_identity_start:
        from gpcsd_tpu import config
        config.set_policy(temporal_identity_start=False)
    if args.f64_factors:
        from gpcsd_tpu import config
        config.set_policy(factor_dtype="float64")
    if args.f64_compute:
        from gpcsd_tpu import config
        config.set_policy(compute_dtype="float64")
    if args.exact_track or args.reps is not None:
        from gpcsd_tpu.ops import kronlik
        if args.exact_track:
            kronlik.EIGH_MIXED_EXACT_TRACK = True
        if args.reps is not None:
            kronlik.EIGH_MIXED_REPS = args.reps

    from scripts.paper_nuts_run import build_model

    model = build_model(args.out_dir, 1200, 100, 0,
                        het_noise="exact" if args.het_exact else "approx")
    with open(os.path.join(args.out_dir, "map_params.pkl"), "rb") as f:
        model.restore_model_params(pickle.load(f))

    fns = model._fns(precondition=True)
    u0 = np.asarray(fns.param_set.pack(model._theta()))
    rng = np.random.default_rng(0)
    du = rng.normal(size=u0.size)
    du /= np.linalg.norm(du)

    ts = np.linspace(-args.scale, args.scale, args.npts)
    Y = model._Y()
    logp = jax.jit(lambda u: -fns.neg_log_joint(u, Y))
    vals = []
    for t in ts:
        vals.append(float(logp(jnp.asarray(u0 + t * du))))
    vals = np.asarray(vals)

    # quadratic fit = local smooth truth; residual = evaluation noise
    coef = np.polyfit(ts, vals, 2)
    resid = vals - np.polyval(coef, ts)
    print("backend:", jax.default_backend())
    print("logp(center) = %.3f" % vals[args.npts // 2])
    print("range over segment = %.3f" % (vals.max() - vals.min()))
    print("RMS quadratic residual (eval noise) = %.4g log-units" % resid.std())
    print("max |residual| = %.4g" % np.abs(resid).max())


if __name__ == "__main__":
    main()
