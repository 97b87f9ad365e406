"""Per-stage cost breakdown of the float32-policy mixed-precision likelihood.

The mixed factor path (kronlik.eigh_mixed, ``set_policy(factor_dtype=
"float32")``) trades f32 speed against evaluation noise.  This script
times its stages in isolation so optimization targets the real
bottleneck instead of a guess: spatial f64 slices-Jacobi vs temporal
df32 refinement sweeps vs f64 elementwise (Kt build, D, reductions).

Run when the device is otherwise idle; every stage is timed over
n_iters distinct inputs with one final block (bench.py's method).
"""

import sys
import time
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_ITERS = 30


def timeit(fn, inputs):
    out = fn(inputs[0])
    import jax

    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for x in inputs:
        out = fn(x)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / len(inputs) * 1e3  # ms


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--temporal-identity-start", action="store_true",
                    help="A/B the opt-in identity-start adaptive temporal "
                         "refinement (config.Policy.temporal_identity_start)"
                         " for the preconditioned paths")
    ap.add_argument("--json-out", default=None,
                    help="also append one JSON line of results to this file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import bench
    from gpcsd_tpu import config
    from gpcsd_tpu.ops import kronlik

    if args.temporal_identity_start:
        config.set_policy(temporal_identity_start=True)

    m = bench.build_problem()
    fns = m._fns(precondition=True)
    Y = m._Y()
    theta = m._theta()
    u0 = np.asarray(fns.param_set.pack(theta))
    rng = np.random.default_rng(0)
    us = [jnp.asarray(u0 + 0.01 * rng.normal(size=u0.size)) for _ in range(N_ITERS)]

    results = {"temporal_identity_start": bool(args.temporal_identity_start)}

    # full value+grad (the hot path)
    vg = jax.jit(jax.value_and_grad(fns.neg_log_joint))
    results["value_and_grad_ms"] = timeit(lambda u: vg(u, Y), us)
    print("value+grad: %.2f ms" % results["value_and_grad_ms"])

    # the NUTS hot path proper: threaded-basis value+grad (basis aux)
    basis0 = jax.tree_util.tree_map(jnp.asarray, fns.basis0)
    vgb = jax.jit(
        jax.value_and_grad(
            lambda u, b: fns.log_prob_basis(u, Y, b)[0]
        )
    )
    results["value_and_grad_threaded_ms"] = timeit(
        lambda u: vgb(u, basis0), us
    )
    print("value+grad (threaded basis): %.2f ms"
          % results["value_and_grad_threaded_ms"])

    # forward only
    f = jax.jit(fns.neg_log_joint)
    results["value_only_ms"] = timeit(lambda u: f(u, Y), us)
    print("value only: %.2f ms" % results["value_only_ms"])

    # factors only (no contraction)
    bf = jax.jit(lambda u: fns.build_factors(fns.param_set.unpack(u)).d)
    results["factors_only_ms"] = timeit(bf, us)
    print("factors only: %.2f ms" % results["factors_only_ms"])

    # spatial eigh alone (f64 slices on accelerator)
    Ks = fns.build_ks(theta)
    Kss = [jnp.asarray(np.asarray(Ks) * (1 + 0.01 * rng.normal())) for _ in range(N_ITERS)]
    se = jax.jit(lambda k: kronlik._factor_eigh(k)[0])
    results["spatial_eigh_ms"] = timeit(se, Kss)
    print("spatial eigh (n=%d): %.2f ms" % (Ks.shape[-1], results["spatial_eigh_ms"]))

    # temporal mixed eigh alone
    Kt = fns.build_kt(theta)
    Kts = [jnp.asarray(np.asarray(Kt) * (1 + 0.01 * rng.normal())) for _ in range(N_ITERS)]
    te = jax.jit(lambda k: kronlik.eigh_mixed(k)[0])
    results["temporal_eigh_mixed_ms"] = timeit(te, Kts)
    print("temporal eigh_mixed (n=%d): %.2f ms" % (Kt.shape[-1], results["temporal_eigh_mixed_ms"]))

    # preconditioned-congruence temporal solve (what the hot path runs):
    # B = q0^T Kt q0 is near-diagonal; identity-start vs f32-eigh-start
    q0 = jnp.asarray(fns.qt0, jnp.float32)
    def cong(k):
        hi, lo = kronlik._split_f32(k)
        B = kronlik._df32_gram(q0, kronlik._df32_apply(hi, lo, q0))
        return 0.5 * (B + B.T)
    teb = jax.jit(lambda k: kronlik._eigh_mixed_ident(cong(k))[0])
    results["temporal_identity_start_ms"] = timeit(teb, Kts)
    print("temporal congruence + identity-start adaptive (n=%d): %.2f ms"
          % (Kt.shape[-1], results["temporal_identity_start_ms"]))
    tec = jax.jit(lambda k: kronlik.eigh_mixed(cong(k))[0])
    results["temporal_congruence_f32start_ms"] = timeit(tec, Kts)
    print("temporal congruence + f32-eigh-start (n=%d): %.2f ms"
          % (Kt.shape[-1], results["temporal_congruence_f32start_ms"]))

    # ---- congruence-stage SUB-stages (round-5: the 12.7 ms temporal
    # congruence stage is ~90% of the likelihood; find where inside) ----
    # (a) the double-f32 congruence build B = q0^T Kt q0 alone
    cb = jax.jit(lambda k: cong(k))
    results["congruence_build_ms"] = timeit(cb, Kts)
    print("congruence build only: %.2f ms" % results["congruence_build_ms"])
    # (b) the f32 Jacobi eigh start alone (on the f32-rounded congruence)
    from gpcsd_tpu.ops.jacobi import eigh_jacobi

    Bs32 = [jnp.asarray(np.asarray(cong(k)), jnp.float32) for k in Kts[:10]]
    j32 = jax.jit(lambda b: eigh_jacobi(b)[0])
    results["f32_jacobi_start_ms"] = timeit(j32, Bs32)
    print("f32 Jacobi start only: %.2f ms" % results["f32_jacobi_start_ms"])
    # (c) refinement sweeps alone, f64 vs f32 rotation builds: the sweep's
    # O(n^2) f64 elementwise angle math
    B64s = [jnp.asarray(np.asarray(cong(k)), jnp.float64) for k in Kts[:10]]

    def sweeps_only(B):
        n = B.shape[-1]
        v = jnp.eye(n, dtype=jnp.float32)
        m_even, m_odd = kronlik._brickwall_masks(n)
        b = B
        for pairing in [m_even, m_odd, None] * kronlik.EIGH_MIXED_REPS:
            b, v = kronlik._mixed_sweep(b, v, pairing)
        return jnp.diagonal(b)

    for flag in (False, True):
        kronlik.EIGH_MIXED_F32_ROTATIONS = flag
        key = "sweeps6_%s_rotations_ms" % ("f32" if flag else "f64")
        results[key] = timeit(jax.jit(sweeps_only), B64s)
        print("%s: %.2f ms" % (key, results[key]))
    kronlik.EIGH_MIXED_F32_ROTATIONS = False
    # (d) full congruence-stage A/B with f32 rotation builds
    kronlik.EIGH_MIXED_F32_ROTATIONS = True
    tec32 = jax.jit(lambda k: kronlik.eigh_mixed(cong(k))[0] + 0.0)
    results["temporal_congruence_f32rot_ms"] = timeit(tec32, Kts)
    print("temporal congruence + f32-rotation sweeps: %.2f ms"
          % results["temporal_congruence_f32rot_ms"])
    kronlik.EIGH_MIXED_F32_ROTATIONS = False

    # Kt build alone (f64 elementwise)
    bk = jax.jit(lambda u: fns.build_kt(fns.param_set.unpack(u)))
    results["kt_build_ms"] = timeit(bk, us)
    print("Kt build: %.2f ms" % results["kt_build_ms"])

    # whiten + quad reduction with fixed factors
    fac = fns.build_factors(theta)
    Ys = [jnp.asarray(np.asarray(Y) + 0.001 * i) for i in range(N_ITERS)]
    lq = jax.jit(lambda y: kronlik.loglik(fac, y))
    results["whiten_quad_ms"] = timeit(lq, Ys)
    print("whiten+quad: %.2f ms" % results["whiten_quad_ms"])

    if args.json_out:
        import json

        with open(args.json_out, "a") as fjs:
            fjs.write(json.dumps(results) + "\n")


if __name__ == "__main__":
    main()
