"""Importance-sampling posterior-moment acceptance: CPU-float64 density
over an accelerator run's dense-metric draws (IS variant).

The exactness contract is CPU float64.  Evaluating the f64 log-density
at every device posterior draw gives self-normalized importance weights
``w_i = exp(logp64(u_i) - logpDEV(u_i))``; when the device-vs-f64 density
difference is a smooth near-constant offset, the reweighted moments
ARE the f64 posterior's moments with ordinary MC error, and

    z_k = |mean_raw - mean_reweighted| / MCSE_k

quantifies how far the device's numerics move each posterior mean.  MCSE uses the
rank-normalized bulk ESS of the raw chains (the weights are ~constant,
so the reweighted estimator shares the chain autocorrelation).

This closes the accuracy loop without a second MCMC run; the MCMC-vs-
MCMC control (scripts/posterior_accuracy.py against the --platform cpu
run) is the independent-sampler cross-check.

    python scripts/posterior_accuracy_is.py --run results/paper_nuts_dense \
        --out results/posterior_accuracy/acceptance_is.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", default="results/paper_nuts_dense")
    ap.add_argument("--ntime", type=int, default=1200)
    ap.add_argument("--ntrials", type=int, default=100)
    ap.add_argument("--out",
                    default="results/posterior_accuracy/acceptance_is.json")
    ap.add_argument("--z-max", type=float, default=3.0)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from scripts.paper_nuts_run import build_model
    from gpcsd_tpu.infer.diagnostics import ess_bulk

    with open(os.path.join(args.run, "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    d = dict(np.load(os.path.join(args.run, "posterior_samples.npz")))
    u = np.asarray(d["raw_u"], dtype=np.float64)  # (chains, S, dim)
    nchains, S, dim = u.shape
    flat = u.reshape(-1, dim)

    if "logp" not in d:
        # older runs did not save per-draw sampler logp in the npz, but
        # the chunked driver's per-chunk outputs (z, logp, stats) are on
        # disk: flattened-pytree slot '1' is logp (nchains, chunk_size)
        import glob

        outs = sorted(glob.glob(os.path.join(args.run,
                                             "nuts_state.out*.npz")))
        if outs:
            warm = int(art["config"]["warmup"])
            lps = [np.load(p)["1"] for p in outs]
            lp_all = np.concatenate(lps, axis=1)
            d["logp"] = lp_all[:, warm:warm + S]
            assert d["logp"].shape == (nchains, S), d["logp"].shape

    model = build_model(
        args.run, args.ntime, args.ntrials, 0,
        het_noise=art.get("config", {}).get("het_noise", "approx"),
    )
    fns = model._fns()
    Y = model._Y()
    lp = jax.jit(jax.vmap(lambda uu: fns.log_prob(uu, Y)))

    # CPU-f64 log-density at every draw, batched + checkpointed (the
    # host is shared; a kill mid-way resumes)
    cache = os.path.join(args.run, "logp64_draws.npy")
    if os.path.exists(cache):
        logp64 = np.load(cache)
    else:
        logp64 = np.full(flat.shape[0], np.nan)
    t0 = time.time()
    for lo in range(0, flat.shape[0], args.batch):
        hi = min(lo + args.batch, flat.shape[0])
        if np.isfinite(logp64[lo:hi]).all():
            continue
        logp64[lo:hi] = np.asarray(lp(jnp.asarray(flat[lo:hi])))
        np.save(cache + ".tmp.npy", logp64)
        os.replace(cache + ".tmp.npy", cache)
        print(f"{hi}/{flat.shape[0]} f64 evals ({time.time()-t0:.0f} s)",
              flush=True)

    # self-normalized IS weights need the sampler's own density at each
    # draw (saved in posterior_samples.npz since round 5, reconstructed
    # from the chunk outputs above for older runs); any constant offset
    # (whitening log-dets etc.) cancels in the normalization
    w = None
    if "logp" in d:
        delta = logp64 - np.asarray(d["logp"], np.float64).reshape(-1)
        delta = delta - delta.max()
        w = np.exp(delta)
        w /= w.sum()
    result = {
        "run": args.run,
        "n_draws": int(flat.shape[0]),
        "logp64_sd_within_chain_mean": float(
            np.std(logp64.reshape(nchains, S), axis=1).mean()
        ),
    }
    eb = ess_bulk(u)
    names = list(art.get("rhat", {}).keys())
    if w is not None:
        ess_frac = float(1.0 / (flat.shape[0] * np.sum(w**2)))
        mean_raw = flat.mean(axis=0)
        mean_rw = (w[:, None] * flat).sum(axis=0)
        sd = flat.std(axis=0, ddof=1)
        mcse = sd / np.sqrt(np.maximum(eb, 1.0))
        z = np.abs(mean_raw - mean_rw) / np.maximum(mcse, 1e-300)
        # the same shift in units of the POSTERIOR sd: at bulk ESS ~2000
        # the MCSE is ~sd/45, so a z of 4.5 is a ~0.1-sd mean shift — the
        # sd-relative number is the scientifically meaningful effect size
        # of device numerics on the posterior, the z is the strict
        # within-MC-error test (both reported; neither replaces the other)
        shift_sd = np.abs(mean_raw - mean_rw) / np.maximum(sd, 1e-300)
        result.update({
            "is_ess_fraction": ess_frac,
            "offset_sd_log_units": float(np.std(
                (logp64 - np.asarray(d["logp"], np.float64).reshape(-1))
            )),
            "z_scores_u_space": dict(zip(names, map(float, z))),
            "max_z": float(z.max()),
            "shift_in_posterior_sd": dict(zip(names, map(float, shift_sd))),
            "max_shift_posterior_sd": float(shift_sd.max()),
            "pass": bool(z.max() < args.z_max and ess_frac > 0.5),
            "pass_shift_lt_0.2_sd": bool(
                shift_sd.max() < 0.2 and ess_frac > 0.5
            ),
        })
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(args.out + ".tmp", args.out)
    print(json.dumps({k: result.get(k) for k in
                      ("max_z", "is_ess_fraction", "pass")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
