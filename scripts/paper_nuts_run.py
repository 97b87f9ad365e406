"""Paper-scale NUTS posterior run at the auditory configuration.

The north-star acceptance run (BASELINE.json; VERDICT round-1 item 1):
GPCSD1D at the auditory-workload size — nx=24, nt=600 baseline window,
100 trials, ngl=100, the paper covariance stack of
``/root/reference/auditory_lfp/fit_gpcsd_baseline.py:80-100`` — MAP fit,
then 4 NUTS chains x (500 warmup + 500 samples) via the chunked driver
with crash resume (``state_path``) and warm-basis threading.

Designed to be re-invoked until done: every stage (surrogate data, MAP
params, sampler chunks, per-chunk timing) checkpoints to ``--out-dir``,
so a crash or an external ``timeout`` just continues.  Exits 0 with a
final JSON artifact once the posterior is complete; a kill/timeout
mid-run leaves the checkpoints behind and a rerun continues.

    python scripts/paper_nuts_run.py --het-exact --dense-mass

Records: samples/s/chip (median sampling-chunk throughput and total-wall),
split-R-hat, ESS, divergence count, step sizes — written to
``<out-dir>/paper_nuts_auditory.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

# runnable as `python scripts/paper_nuts_run.py` from the repo root: the
# workloads package lives next to scripts/, not inside it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


#: (retired round 5) The old calibration constant 4.97e8 was measured
#: through the CSD-draw -> discrete trapezoid forward path, whose
#: amplitude convention differs from the model's own GL-quadrature gain
#: (tr Ks / nx ~ 1.03e5 at the paper geometry) by ~5e3 — the root cause
#: of the off-family surrogate (see paper_surrogate).  The generator now
#: calibrates through the model's own gain directly.


def paper_surrogate(seed, ntime, ntrials):
    """In-family auditory-size surrogate: an EXACT draw from the GPCSD1D
    marginal LFP law at the labeled truth (Kronecker covariance
    ``Ks_model (x) Kt + sig2n I`` through the model's OWN GL-quadrature
    spatial covariance), so "posterior recovers the truth" is a
    well-posed acceptance criterion.

    Round-5 correction: earlier rounds generated via CSD prior draws at
    the 24 electrode sites -> discrete trapezoid forward, whose LFP
    covariance is NOT in the fitted model's family (the model integrates
    a continuous CSD field with 100-node Gauss-Legendre quadrature over
    [-200, 2600]).  Measured on the completed round-5 dense run: the
    posterior mode beats the labeled truth by 1.5e7 log-units and the
    data's actual signal variance is 0.53 vs the model-implied 1.04e-4
    at the labels (an ~5e3 amplitude-convention gap) — the sampler was
    fine; the labels simply did not describe the data.  The sigma2
    labels are now calibrated through the model's own gain
    (``tr Ks / nx``, the amplitude-reparam coordinate) so the mean
    per-channel LFP signal variance is exactly 0.35 + 0.15 vs noise
    0.01 (the paper SNR regime).
    """
    import gpcsd_tpu as g
    from gpcsd_tpu.models.covariances import (
        GPCSD1DSpatialCovSE,
        GPCSDTemporalCovSE,
        GPCSDTemporalCovMatern,
    )
    from workloads.auditory_lfp import A, B, FS, NX

    rng = np.random.default_rng(seed)
    x = np.linspace(A, B, NX).reshape(-1, 1)
    time_ms = (np.arange(ntime) - ntime // 2) / FS * 1000.0
    t = time_ms.reshape(-1, 1)
    # same covariance stack as build_model below (quadrature domain incl.)
    spatial_cov = GPCSD1DSpatialCovSE(x, a=-200.0, b=2600.0)
    gen = g.GPCSD1D(
        np.zeros((NX, ntime, 1)), x, t, a=-200.0, b=2600.0,
        spatial_cov=spatial_cov,
        temporal_cov_list=[GPCSDTemporalCovSE(t), GPCSDTemporalCovMatern(t)],
    )
    gen.R["value"] = 150.0
    gen.spatial_cov.params["ell"]["value"] = 300.0
    gen.temporal_cov_list[0].params["ell"]["value"] = 40.0  # SE, ms
    gen.temporal_cov_list[1].params["ell"]["value"] = 5.0  # Matern, ms
    fns = gen._fns()
    theta = gen._theta()
    Ks = np.asarray(fns.build_ks(theta), dtype=np.float64)
    gain = float(np.trace(Ks) / Ks.shape[0])  # LFP var per unit sigma2
    s0, s1, sig2n = 0.35 / gain, 0.15 / gain, 0.01
    gen.temporal_cov_list[0].params["sigma2"]["value"] = s0
    gen.temporal_cov_list[1].params["sigma2"]["value"] = s1
    Kt = np.asarray(fns.build_kt(gen._theta()), dtype=np.float64)
    nx, nt = Ks.shape[0], Kt.shape[0]
    Ls = np.linalg.cholesky(Ks + 1e-10 * np.trace(Ks) / nx * np.eye(nx))
    Lt = np.linalg.cholesky(Kt + 1e-10 * np.trace(Kt) / nt * np.eye(nt))
    z = rng.standard_normal((ntrials, nx, nt))
    lfp = np.einsum("xy,byt,st->xsb", Ls, z, Lt)
    lfp += np.sqrt(sig2n) * rng.standard_normal(lfp.shape)
    truth = {
        "R": 150.0, "ell": 300.0, "tm0_ell": 40.0, "tm0_sigma2": s0,
        "tm1_ell": 5.0, "tm1_sigma2": s1, "sig2n": sig2n,
    }
    return lfp, time_ms, truth


def build_model(out_dir, ntime, ntrials, seed, het_noise="approx"):
    """Auditory-size data + paper covariance stack (surrogate data cached
    on disk so every resume sees the identical problem)."""
    import gpcsd_tpu as g
    from gpcsd_tpu.models.covariances import (
        GPCSD1DSpatialCovSE,
        GPCSDTemporalCovSE,
        GPCSDTemporalCovMatern,
    )
    from workloads.auditory_lfp import A, B, NX

    data_path = os.path.join(out_dir, "surrogate_lfp.npz")
    if os.path.exists(data_path):
        d = np.load(data_path)
        lfp, time_ms = d["lfp"], d["time_ms"]
    else:
        lfp, time_ms, truth = paper_surrogate(seed, ntime=ntime, ntrials=ntrials)
        tmp = data_path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, lfp=lfp, time_ms=time_ms,
                     **{"truth_" + k: v for k, v in truth.items()})
        os.replace(tmp, data_path)

    base = time_ms < 0  # baseline window, reference :66-70
    t = time_ms[base].reshape(-1, 1)
    x = np.linspace(A, B, NX).reshape(-1, 1)
    spatial_cov = GPCSD1DSpatialCovSE(x, a=-200.0, b=2600.0)
    matern = GPCSDTemporalCovMatern(t)
    matern.params["ell"]["prior"] = g.InvGamma.from_interval(1.0, 20.0)
    se = GPCSDTemporalCovSE(t)
    se.params["ell"]["prior"] = g.InvGamma.from_interval(30.0, 100.0)
    model = g.GPCSD1D(
        lfp[:, base, :], x, t, a=-200.0, b=2600.0,
        spatial_cov=spatial_cov, temporal_cov_list=[se, matern],
        sig2n_prior=[g.HalfNormal(0.1) for _ in range(NX)],
        # het_noise="exact" is the production choice for sampling: the
        # reference's heteroscedastic-noise eigenbasis approximation
        # (utility_functions.py:54-63) puts the per-MODE denominator at
        # sig2n (~0.01) for deep spatial quadrature-Gram modes, amplifying
        # eigensolver error in that subspace by ~1/sig2n.  The exact
        # noise-whitened factorization (d ~ 1 for deep modes) costs the
        # same.
        het_noise=het_noise,
    )
    return model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/paper_nuts")
    ap.add_argument("--ntime", type=int, default=1200)  # 600 pre-stimulus
    ap.add_argument("--ntrials", type=int, default=100)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=10,
                    help="NUTS transitions per dispatch (the checkpoint "
                         "and progress cadence)")
    ap.add_argument("--max-depth", type=int, default=8,
                    help="NUTS max tree depth; 8 caps a dispatch at 256 "
                         "leapfrogs/chain (bounds worst-case device time)")
    ap.add_argument("--restarts", type=int, default=10)
    ap.add_argument("--map-maxiter", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pool-warmup", action="store_true",
                    help="pool the mass-matrix adaptation statistics across "
                         "chains at chunk boundaries (each window sees 4x "
                         "the draws; step-size adaptation stays per-chain). "
                         "Changes the resume fingerprint — don't toggle "
                         "mid-run.")
    ap.add_argument("--dense-mass", action="store_true",
                    help="adapt a full-covariance metric during warmup "
                         "(Stan dense_e analog) — the geometry lever that "
                         "made the round-4 rescue run healthy (max_rhat "
                         "1.0011 vs 13.3 for the diagonal metric on the "
                         "same posterior); the production configuration "
                         "since round 5")
    ap.add_argument("--hessian", choices=["map", "pooled"], default="map",
                    help="whitening source: the CPU-f64 MAP Hessian "
                         "(default) or the pooled-draw covariance inverse "
                         "of a completed prior run (--pooled-from)")
    ap.add_argument("--pooled-from", default=None,
                    help="directory of a completed run whose "
                         "posterior_samples.npz supplies the pooled-draw "
                         "covariance (required with --hessian pooled)")
    ap.add_argument("--shrink", type=float, default=0.1,
                    help="shrinkage of the pooled covariance toward its "
                         "diagonal (with --hessian pooled)")
    ap.add_argument("--inputs-from", default=None,
                    help="directory of a prior run to copy cached inputs "
                         "from (surrogate, MAP params, mode params, f64 "
                         "Hessian) — skips the MAP/Hessian stages so a "
                         "re-run with different sampler settings samples "
                         "the IDENTICAL posterior")
    ap.add_argument("--reparam", default=None, choices=["amplitude"],
                    help="sample in amplitude-reparameterized coordinates "
                         "(models/reparam.py): log total signal power + "
                         "power ratios instead of raw (R, sigma2) — "
                         "removes the forward-amplitude ridge at the "
                         "source (round-5 A/B lever)")
    ap.add_argument("--het-exact", action="store_true",
                    help="het_noise='exact': exact noise-whitened "
                         "Kronecker factorization instead of the "
                         "reference's eigenbasis approximation — removes "
                         "the 1/sig2n amplification of deep spatial-mode "
                         "eigenvector error")
    ap.add_argument("--platform", default=None, choices=["cpu"],
                    help="force the jax platform (set via jax.config "
                         "before first use) — the CPU float64 control "
                         "posterior on the same surrogate")
    ap.add_argument("--gen-surrogate-only", action="store_true",
                    help="generate + cache the surrogate on CPU and exit "
                         "(the main pipeline runs this stage in a CPU "
                         "subprocess)")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="exit 3 cleanly at the next checkpoint boundary "
                         "after this much wall time, so a retry loop can "
                         "budget inside its timeout")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    t_process0 = time.time()

    if args.platform:
        import jax as _jax

        _jax.config.update("jax_platforms", args.platform)

    if args.gen_surrogate_only:
        import jax

        jax.config.update("jax_platforms", "cpu")
        build_model(args.out_dir, args.ntime, args.ntrials, args.seed)
        print("surrogate cached", flush=True)
        return 0

    if args.inputs_from:
        import shutil

        for fname in ("surrogate_lfp.npz", "map_params.pkl",
                      "mode_params.pkl", "hessian_f64.npz"):
            src = os.path.join(args.inputs_from, fname)
            dst = os.path.join(args.out_dir, fname)
            if os.path.exists(src) and not os.path.exists(dst):
                shutil.copy2(src, dst)
                print(f"inputs: copied {fname} from {args.inputs_from}",
                      flush=True)

    if not os.path.exists(os.path.join(args.out_dir, "surrogate_lfp.npz")):
        import subprocess

        subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--gen-surrogate-only", "--out-dir", args.out_dir,
             "--ntime", str(args.ntime), "--ntrials", str(args.ntrials),
             "--seed", str(args.seed)],
            check=True,
        )

    import jax  # noqa: F401  (device selection: JAX's default device)

    model = build_model(args.out_dir, args.ntime, args.ntrials, args.seed,
                        het_noise="exact" if args.het_exact else "approx")

    # stage 1: MAP (reference fit, 10 restarts) — also the NUTS
    # preconditioning center; cached like the reference's pickles
    map_path = os.path.join(args.out_dir, "map_params.pkl")
    if os.path.exists(map_path):
        with open(map_path, "rb") as f:
            model.restore_model_params(pickle.load(f))
        print("MAP: restored from cache", flush=True)
    else:
        from gpcsd_tpu.infer.lbfgs import LBFGSTimeBudget

        t0 = time.time()
        try:
            model.fit(
                n_restarts=args.restarts, seed=args.seed, verbose=True,
                options={
                    "maxiter": args.map_maxiter,
                    # optimizer-state checkpointing: MAP progress survives
                    # a crash or a time budget just like the sampler's does
                    "chunk_iters": 3,
                    "state_path": os.path.join(args.out_dir, "map_state"),
                    "max_wall_seconds": args.max_seconds,
                },
            )
        except LBFGSTimeBudget as e:
            print(f"MAP stage: {e}", flush=True)
            return 3
        with open(map_path + ".tmp", "wb") as f:
            pickle.dump(model.extract_model_params(), f)
        os.replace(map_path + ".tmp", map_path)
        print(f"MAP: fitted in {time.time() - t0:.1f} s", flush=True)

    # stage 1b: float64 Laplace whitening Hessian at the MAP, computed in a
    # CPU-backend subprocess (scripts/laplace_hessian.py), which also
    # polishes the MAP to the unconstrained mode
    hess_path = os.path.join(args.out_dir, "hessian_f64.npz")
    if not os.path.exists(hess_path):
        import subprocess

        t0 = time.time()
        subprocess.run(
            [
                sys.executable, os.path.join(
                    os.path.dirname(os.path.abspath(__file__)),
                    "laplace_hessian.py",
                ),
                "--paper-dir", args.out_dir,
                "--ntime", str(args.ntime),
                "--ntrials", str(args.ntrials),
                "--seed", str(args.seed),
            ],
            check=True,
        )
        print(f"Laplace Hessian (CPU f64): {time.time() - t0:.1f} s", flush=True)

    # center sampling at the unconstrained f64 mode (== the box MAP when no
    # bound binds; see scripts/laplace_hessian.py) so the whitening Hessian,
    # the preconditioning eigenbasis, and the chain inits are all consistent
    mode_path = os.path.join(args.out_dir, "mode_params.pkl")
    if os.path.exists(mode_path):
        with open(mode_path, "rb") as f:
            model.restore_model_params(pickle.load(f))

    # whitening source: MAP Hessian (default) or the pooled-draw covariance
    # inverse of a completed prior run (the round-4 rescue path, unified
    # here per VERDICT r4 #7 — one driver, one artifact schema)
    whiten = hess_path
    if args.hessian == "pooled":
        pooled_path = os.path.join(args.out_dir, "hessian_pooled.npz")
        if os.path.exists(pooled_path):
            whiten = np.load(pooled_path)["H"]
        else:
            if not args.pooled_from:
                print("--hessian pooled requires --pooled-from", flush=True)
                return 2
            d = np.load(os.path.join(args.pooled_from,
                                     "posterior_samples.npz"))
            u = np.asarray(d["raw_u"], dtype=np.float64)  # (chains, S, dim)
            flat = u.reshape(-1, u.shape[-1])
            cov = np.cov(flat.T)
            cov = (1.0 - args.shrink) * cov + args.shrink * np.diag(np.diag(cov))
            w, Q = np.linalg.eigh(cov)
            w = np.maximum(w, 1e-8 * w.max())
            H = (Q * (1.0 / w)) @ Q.T
            with open(pooled_path + ".tmp", "wb") as f:
                np.savez(f, H=H, cov=(Q * w) @ Q.T, eigs=w)
            os.replace(pooled_path + ".tmp", pooled_path)
            print("pooled covariance: eig range [%.3e, %.3e]"
                  % (w.min(), w.max()), flush=True)
            whiten = H

    # stage 2: chunked NUTS with crash resume + per-chunk timing sidecar
    timing_path = os.path.join(args.out_dir, "chunk_timing.json")
    timing = {}
    if os.path.exists(timing_path):
        with open(timing_path) as f:
            timing = json.load(f)

    last = {"t": time.time()}
    # budget measured from PROCESS start: earlier stages (MAP resume, mode
    # polish, Hessian) eat into it, so the exit always lands before an
    # external `timeout` would kill us mid-dispatch
    t_start = t_process0
    save_every = 5

    class _TimeBudget(Exception):
        pass

    def cb(c, carry):
        now = time.time()
        timing[str(c)] = now - last["t"]
        last["t"] = now
        with open(timing_path + ".tmp", "w") as f:
            json.dump(timing, f)
        os.replace(timing_path + ".tmp", timing_path)
        print(f"chunk {c}: {timing[str(c)]:.1f} s", flush=True)
        # clean stop at a checkpoint boundary (the driver saves BEFORE the
        # callback, so everything up to chunk c is durable here)
        if (
            args.max_seconds is not None
            and now - t_start > args.max_seconds
            and (c + 1) % save_every == 0
        ):
            raise _TimeBudget

    t_run0 = time.time()
    try:
        post = model.sample_posterior(
            n_chains=args.chains,
            num_warmup=args.warmup,
            num_samples=args.samples,
            seed=args.seed,
            chunk_size=args.chunk,
            max_depth=args.max_depth,
            state_path=os.path.join(args.out_dir, "nuts_state"),
            save_every=save_every,  # warm-basis carry is MBs; amortize I/O
            callback=cb,
            laplace_hessian=whiten,
            pool_warmup=args.pool_warmup,
            dense_mass=args.dense_mass,
            reparam=args.reparam,
        )
    except _TimeBudget:
        print(
            f"time budget reached after {time.time() - t_run0:.0f} s — "
            "checkpointed; rerun to continue", flush=True,
        )
        return 3
    wall_this_attempt = time.time() - t_run0

    # throughput: median sampling-phase chunk duration (excludes the
    # compile-bearing first chunk of every attempt, which shows up as an
    # outlier), plus the conservative total-wall figure
    n_chunks_warm = args.warmup // args.chunk
    samp_durs = [v for k, v in timing.items() if int(k) >= n_chunks_warm]
    warm_durs = [v for k, v in timing.items() if int(k) < n_chunks_warm]
    med = float(np.median(samp_durs)) if samp_durs else float("nan")
    total_known = float(np.sum(list(timing.values())))
    samples_per_s_median = args.chains * args.chunk / med if med == med else None
    samples_per_s_wall = (
        args.chains * args.samples
        / float(np.sum(samp_durs))
        if samp_durs else None
    )

    div = int(np.asarray(post.diagnostics["diverging"]).sum())
    rhat = {k: float(v) for k, v in post.diagnostics.get("rhat", {}).items()}
    ess = {k: float(v) for k, v in post.diagnostics.get("ess", {}).items()}
    ess_t = {
        k: float(v) for k, v in post.diagnostics.get("ess_tail", {}).items()
    }
    result = {
        "config": {
            "nx": 24, "nt": int(np.sum(np.load(
                os.path.join(args.out_dir, "surrogate_lfp.npz"))["time_ms"] < 0)),
            "ntrials": args.ntrials, "ngl": 100,
            "chains": args.chains, "warmup": args.warmup,
            "samples": args.samples, "chunk_size": args.chunk,
            "max_depth": args.max_depth,
            "het_noise": "exact" if args.het_exact else "approx",
            "metric": (
                ("dense_mass + " if args.dense_mass else "")
                + ("map-hessian" if args.hessian == "map" else "pooled-cov")
                + " whitening"
                + (" + amplitude-reparam" if args.reparam else "")
            ),
        },
        "backend": jax.default_backend(),
        "n_devices": jax.device_count(),
        "samples_per_s_per_chip_median": samples_per_s_median,
        "samples_per_s_per_chip_wall": samples_per_s_wall,
        "median_sampling_chunk_s": med,
        "median_warmup_chunk_s": float(np.median(warm_durs)) if warm_durs else None,
        "total_chunk_wall_s": total_known,
        "divergences": div,
        "mean_leapfrogs_per_sample": float(
            np.asarray(post.diagnostics["num_steps"]).mean()
        ),
        "mean_acceptance": float(
            np.asarray(post.diagnostics["accept_prob"]).mean()
        ),
        "max_rhat": max(rhat.values()) if rhat else None,
        "min_ess": min(ess.values()) if ess else None,
        "min_ess_tail": min(ess_t.values()) if ess_t else None,
        "rhat": rhat,
        "ess": ess,
        "ess_tail": ess_t,
        "step_size": np.asarray(post.diagnostics["step_size"]).tolist(),
        "posterior_mean": {
            k: np.asarray(v).mean(axis=0).tolist() for k, v in post.theta.items()
        },
        "posterior_sd": {
            k: np.asarray(v).std(axis=0).tolist() for k, v in post.theta.items()
        },
    }
    # ground-truth recovery: the surrogate is drawn FROM the model family
    # with known hyperparameters (paper_surrogate), so the posterior should
    # cover them — report truth + central-interval quantiles per parameter
    with np.load(os.path.join(args.out_dir, "surrogate_lfp.npz")) as dsur:
        truth = {
            k[len("truth_"):]: float(dsur[k])
            for k in dsur.files if k.startswith("truth_")
        }
    if truth:
        result["truth"] = truth
        q = {}
        for k, v in post.theta.items():
            v = np.asarray(v)
            q[k] = {
                "q05": np.quantile(v, 0.05, axis=0).tolist(),
                "q50": np.quantile(v, 0.50, axis=0).tolist(),
                "q95": np.quantile(v, 0.95, axis=0).tolist(),
            }
        result["posterior_quantiles"] = q
    out = os.path.join(args.out_dir, "paper_nuts_auditory.json")
    with open(out + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(out + ".tmp", out)
    # full constrained draws + per-transition diagnostics for the figure
    # stage (scripts/paper_figures.py) and for posterior spot-checks
    samp_path = os.path.join(args.out_dir, "posterior_samples.npz")
    with open(samp_path + ".tmp", "wb") as f:
        np.savez(
            f,
            **{k: np.asarray(v) for k, v in post.theta.items()},
            raw_u=np.asarray(post.raw.samples),  # (chains, nsamples, dim)
            logp=np.asarray(post.raw.logp),  # per-draw sampler density
            diag_num_steps=np.asarray(post.diagnostics["num_steps"]),
            diag_diverging=np.asarray(post.diagnostics["diverging"]),
            diag_step_size=np.asarray(post.diagnostics["step_size"]),
        )
    os.replace(samp_path + ".tmp", samp_path)
    print(json.dumps({k: result[k] for k in (
        "samples_per_s_per_chip_median", "samples_per_s_per_chip_wall",
        "divergences", "max_rhat", "min_ess")}), flush=True)
    print(f"DONE -> {out} (this attempt: {wall_this_attempt:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
