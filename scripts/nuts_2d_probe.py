"""GPCSD2D NUTS throughput probe at the Neuropixels size.

BASELINE.json config 5 asks for the 2D model under the samplers "at scale".
This drives the full production sampler stack (Laplace-whitened, chunked,
crash-resumable NUTS through ``InferenceAPIMixin.sample_posterior``) on the
largest reference problem — nx=69 channels, nt=375, 100 trials, ngl 30x120
(reference ``neuropixels/fit_gpcsd2d.py:77-91``) — and records
samples/s/chip.  A short run by paper-run standards (default 4 x (20+20)):
the purpose is mechanical viability + throughput of 2D NUTS on the chip,
not a converged posterior (that is the 1D paper run's job; a full 2D
posterior is a straight --warmup/--samples bump away with resume).

Usage (resumable; rerun until it prints DONE):

    for i in $(seq 1 10); do
        timeout 1500 python scripts/nuts_2d_probe.py --max-seconds 1250 && break
    done
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_probe_model(out_dir, seed):
    """Neuropixels-size GPCSD2D with MODEL-FAMILY surrogate data (cached).

    A sampler probe on pure-noise data is degenerate (the round-3 bench
    fallback adapted to ~1 leapfrog/sample on noise data — VERDICT r3 weak
    #1), so the probe draws LFP from the model itself: prior Kronecker
    draw through the 2D quadrature LFP covariance at realistic SNR
    (signal variance ~0.5 vs sig2n 0.01, the paper-run regime).
    """
    from scripts.bench_2d import build_problem

    import numpy as _np

    m = build_problem(seed=seed)
    data_path = os.path.join(out_dir, "surrogate_lfp_2d.npz")
    if os.path.exists(data_path):
        d = _np.load(data_path)
        lfp = d["lfp"]
        s1, s2, sig2n = float(d["s1"]), float(d["s2"]), float(d["sig2n"])
    else:
        rng = _np.random.default_rng(seed)
        fns = m._fns()
        theta = m._theta()
        Ks = _np.asarray(fns.build_ks(theta), dtype=_np.float64)
        c = float(_np.mean(_np.diag(Ks)))
        s1, s2, sig2n = 0.35 / c, 0.15 / c, 0.01
        m.temporal_cov_list[0].params["sigma2"]["value"] = s1
        m.temporal_cov_list[1].params["sigma2"]["value"] = s2
        m.sig2n["value"] = sig2n
        Kt = _np.asarray(fns.build_kt(m._theta()), dtype=_np.float64)
        nx, nt = Ks.shape[0], Kt.shape[0]
        Ls = _np.linalg.cholesky(Ks + 1e-10 * _np.trace(Ks) / nx * _np.eye(nx))
        Lt = _np.linalg.cholesky(Kt + 1e-10 * _np.trace(Kt) / nt * _np.eye(nt))
        from scripts.bench_2d import NTRIALS

        z = rng.normal(size=(NTRIALS, nx, nt))
        lfp = _np.einsum("xy,byt,st->xsb", Ls, z, Lt)
        lfp += _np.sqrt(sig2n) * rng.normal(size=lfp.shape)
        tmp = data_path + ".tmp.npz"
        with open(tmp, "wb") as f:
            _np.savez(f, lfp=lfp, s1=s1, s2=s2, sig2n=sig2n)
        os.replace(tmp, data_path)
    m.temporal_cov_list[0].params["sigma2"]["value"] = s1
    m.temporal_cov_list[1].params["sigma2"]["value"] = s2
    m.sig2n["value"] = sig2n
    m.lfp = lfp
    return m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/nuts_2d")
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=None)
    ap.add_argument("--dense-mass", action="store_true",
                    help="full-covariance warmup metric (Stan dense_e) — "
                         "the geometry lever that made the 1D paper run "
                         "healthy; the round-4 2D probe without it showed "
                         "the same ridge pathology (acceptance 0.056, 69 "
                         "divergences, two chains pinned at ~1e-9)")
    ap.add_argument("--pool-warmup", action="store_true",
                    help="share metric-adaptation statistics across chains "
                         "at chunk boundaries")
    ap.add_argument("--reparam", default=None, choices=["amplitude"],
                    help="amplitude reparameterization (models/reparam.py)")
    ap.add_argument("--prep-only", action="store_true",
                    help="CPU stage: generate+cache the surrogate and the "
                         "float64 FD Hessian at the generating parameters "
                         "(same as the paper run's scripts/laplace_hessian.py), "
                         "then exit")
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    t0_process = time.time()

    hess_path = os.path.join(args.out_dir, "hessian_f64_2d.npz")
    if args.prep_only:
        import jax

        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp

        assert jax.default_backend() == "cpu", jax.default_backend()
        m = build_probe_model(args.out_dir, args.seed)
        if not os.path.exists(hess_path):
            fns = m._fns()
            Y = m._Y()
            u0 = jnp.asarray(fns.param_set.pack(m._theta()))
            dim = u0.shape[0]
            h = 1e-4
            eye = h * jnp.eye(dim, dtype=u0.dtype)
            pts = jnp.concatenate([u0[None] + eye, u0[None] - eye], axis=0)
            gs = jax.jit(
                jax.vmap(jax.grad(lambda u: fns.neg_log_joint(u, Y)))
            )(pts)
            H = np.asarray((gs[:dim] - gs[dim:]) / (2 * h), dtype=np.float64).T
            H = 0.5 * (H + H.T)
            with open(hess_path + ".tmp", "wb") as f:
                np.savez(f, H=H, u0=np.asarray(u0))
            os.replace(hess_path + ".tmp", hess_path)
        print("prep done (surrogate + f64 Hessian cached)", flush=True)
        return 0

    if not (
        os.path.exists(hess_path)
        and os.path.exists(os.path.join(args.out_dir, "surrogate_lfp_2d.npz"))
    ):
        import subprocess

        subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--prep-only",
             "--out-dir", args.out_dir, "--seed", str(args.seed)],
            check=True,
        )

    import jax  # noqa: F401

    m = build_probe_model(args.out_dir, args.seed)

    timing_path = os.path.join(args.out_dir, "chunk_timing.json")
    timing = {}
    if os.path.exists(timing_path):
        with open(timing_path) as f:
            timing = json.load(f)
    last = {"t": time.time()}
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
        if (
            args.max_seconds is not None
            and now - t0_process > args.max_seconds
            and (c + 1) % save_every == 0
        ):
            raise _TimeBudget

    try:
        post = m.sample_posterior(
            n_chains=args.chains,
            num_warmup=args.warmup,
            num_samples=args.samples,
            seed=args.seed,
            chunk_size=args.chunk,
            max_depth=args.max_depth,
            state_path=os.path.join(args.out_dir, "nuts_state"),
            save_every=save_every,
            callback=cb,
            laplace_hessian=hess_path,
            dense_mass=args.dense_mass,
            pool_warmup=args.pool_warmup,
            reparam=args.reparam,
        )
    except _TimeBudget:
        print("time budget reached — checkpointed; rerun to continue", flush=True)
        return 3

    n_chunks_warm = args.warmup // args.chunk
    samp = [v for k, v in timing.items() if int(k) >= n_chunks_warm]
    med = float(np.median(samp)) if samp else float("nan")
    result = {
        "config": {
            "nx": 69, "nt": 375, "ntrials": 100, "ngl": [30, 120],
            "chains": args.chains, "warmup": args.warmup,
            "samples": args.samples, "max_depth": args.max_depth,
            "chunk_size": args.chunk,
            "metric": (
                ("dense_mass + " if args.dense_mass else "")
                + "map-hessian whitening"
                + (" + amplitude-reparam" if args.reparam else "")
            ),
        },
        "backend": __import__("jax").default_backend(),
        "samples_per_s_per_chip_median": args.chains * args.chunk / med,
        "median_sampling_chunk_s": med,
        "mean_leapfrogs_per_sample": float(
            np.asarray(post.diagnostics["num_steps"]).mean()
        ),
        "mean_acceptance": float(
            np.asarray(post.diagnostics["accept_prob"]).mean()
        ),
        "divergences": int(np.asarray(post.diagnostics["diverging"]).sum()),
        "max_rhat": (
            max(float(np.max(v)) for v in post.diagnostics["rhat"].values())
            if post.diagnostics.get("rhat") else None
        ),
        "min_ess": (
            min(float(np.min(v)) for v in post.diagnostics["ess"].values())
            if post.diagnostics.get("ess") else None
        ),
        "min_ess_tail": (
            min(float(np.min(v))
                for v in post.diagnostics["ess_tail"].values())
            if post.diagnostics.get("ess_tail") else None
        ),
        "step_size": np.asarray(post.diagnostics["step_size"]).tolist(),
    }
    out = os.path.join(args.out_dir, "nuts_2d_probe.json")
    with open(out + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(out + ".tmp", out)
    samp_out = os.path.join(args.out_dir, "posterior_samples_2d.npz")
    with open(samp_out + ".tmp", "wb") as f:
        np.savez(
            f,
            raw_u=np.asarray(post.raw.samples),
            diag_num_steps=np.asarray(post.diagnostics["num_steps"]),
            diag_diverging=np.asarray(post.diagnostics["diverging"]),
            diag_step_size=np.asarray(post.diagnostics["step_size"]),
        )
    os.replace(samp_out + ".tmp", samp_out)
    print(json.dumps({k: result[k] for k in (
        "samples_per_s_per_chip_median", "mean_leapfrogs_per_sample",
        "divergences")}), flush=True)
    print(f"DONE -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
