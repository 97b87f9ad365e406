"""Neuropixels-size GPCSD2D benchmark: log-joint value+gradient throughput.

Problem size = the Neuropixels workload (reference
``neuropixels/fit_gpcsd2d.py:77-91``): nx=69 channels on a 2-column probe
geometry, nt=375 time points (150 ms window at 2.5 kHz), 100 trials,
ngl 30x120 quadrature (3600-node Gram), eps=1 — the largest problem the
reference fits, and the 2D analogue of bench.py's auditory-size headline.

Exercises on the device: the 3600^2 quadrature Gram matmul chain in
``ops/spatial.compkphi_2d``, the nt=375 temporal eigh, and the batched
trial contraction.

Prints one JSON line per configuration.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

NT, NTRIALS = 375, 100
NGL1, NGL2 = 30, 120


def build_problem(seed=0):
    import gpcsd_tpu as g

    rng = np.random.default_rng(seed)
    # Neuropixels staggered 4-column geometry: 69 channels, 2 per 20 um row
    # (reference neuropixels/extract_data.py:20-42 channel->(x,y) map)
    cols = np.array([16.0, 48.0, 0.0, 32.0])
    idx = np.arange(69)
    x = np.stack([cols[idx % 4], 20.0 * (idx // 2)], axis=1)
    t = np.arange(NT).reshape(-1, 1) * 0.4  # 2.5 kHz
    # padded domain as in the reference fit (fit_gpcsd2d.py:88-90)
    lfp = rng.normal(size=(x.shape[0], NT, NTRIALS))
    m = g.GPCSD2D(lfp, x, t, ngl1=NGL1, ngl2=NGL2, eps=1.0,
                  a1=x[:, 0].min() - 16.0, b1=x[:, 0].max() + 16.0,
                  a2=x[:, 1].min() - 100.0, b2=x[:, 1].max() + 100.0)
    m.R["value"] = 100.0
    m.spatial_cov.params["ell1"]["value"] = 40.0
    m.spatial_cov.params["ell2"]["value"] = 150.0
    m.temporal_cov_list[0].params["ell"]["value"] = 10.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 2.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.1
    return m


def bench(m, n_iters=30):
    import jax
    import jax.numpy as jnp

    fns = m._fns(precondition=True)
    Y = m._Y()
    u0 = np.asarray(fns.param_set.pack(m._theta()))
    vg = jax.jit(jax.value_and_grad(fns.neg_log_joint))
    us = jnp.asarray(
        u0[None, :] + 0.01 * np.random.default_rng(1).normal(size=(n_iters, u0.size))
    )
    t0 = time.perf_counter()
    f, gr = vg(us[0], Y)
    f.block_until_ready()
    compile_s = time.perf_counter() - t0
    if not np.isfinite(float(f)):
        raise RuntimeError(f"non-finite log-joint: {float(f)}")
    t0 = time.perf_counter()
    for i in range(n_iters):
        f, gr = vg(us[i], Y)
    f.block_until_ready()
    dt = time.perf_counter() - t0
    return n_iters / dt, compile_s, float(f)


def bench_baseline(m, n_iters=3):
    """Reference-semantics forward pass in plain numpy float64 (the 2D
    analogue of bench.py's baseline: quadrature covariance, two eighs,
    per-trial quad-form loop, ``gpcsd2d.py:136-151``).  The real reference
    additionally pays autograd's reverse pass per objective gradient."""
    import numpy as np

    x = m.x
    Y = m.lfp
    t = m.t.reshape(-1)
    theta = m._theta()
    fns = m._fns()
    gl = m.spatial_cov  # reuse precomputed GL grid/weights for fairness
    delta_w = np.asarray(gl.delta_w)
    gl_w = np.asarray(gl.gl_w_prod)
    glg = np.asarray(gl.gl_x_grid)
    R, e = float(theta["R"]), m.eps
    ell1, ell2 = float(theta["ell1"]), float(theta["ell2"])

    def one(jit):
        b = np.log(R + e + np.sqrt((R + e) ** 2 + delta_w**2)) - np.log(
            e + np.sqrt(e**2 + delta_w**2)
        )
        A = gl_w[None, :] * b  # (nx, ngl)
        d1 = glg[:, None, 0] - glg[None, :, 0]
        d2 = glg[:, None, 1] - glg[None, :, 1]
        Kgl = np.exp(-0.5 * (d1 / (ell1 * jit)) ** 2 - 0.5 * (d2 / ell2) ** 2)
        Ks = A @ Kgl @ A.T + 1e-7 * np.eye(x.shape[0])
        dt_ = t[:, None] - t[None, :]
        Kt = float(theta["tm0_sigma2"]) * np.exp(
            -0.5 * (dt_ / float(theta["tm0_ell"])) ** 2
        ) + float(theta["tm1_sigma2"]) * np.exp(-np.abs(dt_) / float(theta["tm1_ell"]))
        lt, Qt = np.linalg.eigh(Kt)
        ls, Qs = np.linalg.eigh(Ks)
        Dvec = np.repeat(ls, t.size) * np.tile(lt, x.shape[0]) + float(theta["sig2n"])
        out = -0.5 * Y.shape[2] * np.sum(np.log(Dvec))
        for trial in range(Y.shape[2]):
            alpha = (Qs.T @ Y[:, :, trial] @ Qt).reshape(-1)
            out -= 0.5 * np.sum(alpha**2 / Dvec)
        return out

    one(1.0)
    t0 = time.perf_counter()
    for i in range(n_iters):
        one(1.0 + 1e-4 * i)
    return n_iters / (time.perf_counter() - t0)


def main():
    m = build_problem()
    rate, compile_s, val = bench(m)
    base = bench_baseline(m)
    print(
        json.dumps(
            {
                "metric": "GPCSD2D log-joint value+grad evals/s "
                f"(nx=69,nt={NT},trials={NTRIALS},ngl={NGL1}x{NGL2})",
                "value": round(rate, 3),
                "unit": "evals/s",
                "compile_s": round(compile_s, 1),
                "neg_log_joint": round(val, 3),
                "vs_baseline": round(rate / base, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
