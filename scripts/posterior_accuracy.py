"""Posterior-moment accuracy acceptance: accelerator dense-metric NUTS vs
a CPU-float64 control posterior vs ground truth.

The BASELINE north star requires "posterior moments within MC error of
reference".  The exactness contract is CPU float64 (SURVEY.md §5), so the
control is the SAME unified driver (``scripts/paper_nuts_run.py
--platform cpu``) on the SAME cached surrogate / MAP / Hessian inputs —
an independent sampler run whose only systematic difference from the
device run is the device's numerics.

Per shared parameter this script records

    z = |mean_dev - mean_cpu| / sqrt(sd_dev^2/ess_dev + sd_cpu^2/ess_cpu)

(the combined Monte-Carlo standard error, each side's MCSE from its
rank-normalized bulk ESS) and the acceptance gate ``max |z| < 3``.  It
also reports truth-coverage z-scores ``(mean - truth) / posterior_sd``
for the surrogate's known hyperparameters — those measure posterior
identification (how far truth sits within the posterior), NOT numerical
agreement, and are reported unguarded.

    python scripts/posterior_accuracy.py \
        --device-run results/paper_nuts_dense --cpu results/paper_nuts_cpu64 \
        --out results/posterior_accuracy/acceptance.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_run(run_dir):
    with open(os.path.join(run_dir, "paper_nuts_auditory.json")) as f:
        art = json.load(f)
    with np.load(os.path.join(run_dir, "posterior_samples.npz")) as d:
        u = np.asarray(d["raw_u"], dtype=np.float64)  # (chains, S, dim)
    return art, u


def moments(u, names):
    """Per-parameter (mean, sd, bulk ESS) from unconstrained draws."""
    from gpcsd_tpu.infer.diagnostics import ess_bulk

    flat = u.reshape(-1, u.shape[-1])
    eb = ess_bulk(u)
    return {
        n: {
            "mean": float(flat[:, i].mean()),
            "sd": float(flat[:, i].std(ddof=1)),
            "ess": float(eb[i]),
        }
        for i, n in enumerate(names)
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device-run", default="results/paper_nuts_dense")
    ap.add_argument("--cpu", default="results/paper_nuts_cpu64")
    ap.add_argument("--out",
                    default="results/posterior_accuracy/acceptance.json")
    ap.add_argument("--z-max", type=float, default=3.0)
    args = ap.parse_args()

    art_t, u_t = load_run(args.device_run)
    art_c, u_c = load_run(args.cpu)
    names = list(art_t.get("rhat", {}).keys())
    assert len(names) == u_t.shape[-1] == u_c.shape[-1], (
        len(names), u_t.shape, u_c.shape,
    )
    m_t = moments(u_t, names)
    m_c = moments(u_c, names)

    z = {}
    for n in names:
        mt, mc = m_t[n], m_c[n]
        mcse = np.sqrt(mt["sd"] ** 2 / mt["ess"] + mc["sd"] ** 2 / mc["ess"])
        z[n] = float(abs(mt["mean"] - mc["mean"]) / mcse) if mcse > 0 else 0.0
    max_z = max(z.values())

    # truth coverage (identification, not numerics): constrained-space
    # means vs the surrogate's generating hyperparameters, scaled by the
    # posterior sd — from the artifact's own constrained summaries
    truth = art_t.get("truth", {})
    coverage = {}
    for k, tv in truth.items():
        pm = art_t.get("posterior_mean", {}).get(k)
        ps = art_t.get("posterior_sd", {}).get(k)
        if pm is None or ps is None:
            continue
        pm, ps, tv = np.atleast_1d(pm), np.atleast_1d(ps), np.atleast_1d(tv)
        with np.errstate(divide="ignore", invalid="ignore"):
            zz = (pm - tv) / np.where(ps > 0, ps, np.nan)
        coverage[k] = [float(v) for v in np.atleast_1d(zz)]

    result = {
        "device_run": args.device_run,
        "cpu_run": args.cpu,
        "device_backend": art_t.get("backend"),
        "cpu_backend": art_c.get("backend"),
        "device_health": {
            "max_rhat": art_t.get("max_rhat"),
            "min_ess": art_t.get("min_ess"),
            "divergences": art_t.get("divergences"),
        },
        "cpu_health": {
            "max_rhat": art_c.get("max_rhat"),
            "min_ess": art_c.get("min_ess"),
            "divergences": art_c.get("divergences"),
        },
        "z_scores_u_space": z,
        "max_z": max_z,
        "z_max_gate": args.z_max,
        "pass": bool(max_z < args.z_max),
        "device_moments_u": m_t,
        "cpu_moments_u": m_c,
        "truth_coverage_z": coverage,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(args.out + ".tmp", args.out)
    print(json.dumps({"max_z": max_z, "pass": result["pass"],
                      "out": args.out}))
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
