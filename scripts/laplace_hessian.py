"""Float64 Laplace (MAP-Hessian) whitening matrix for the paper NUTS run.

Computes the Hessian of the negative log joint at the cached MAP in
float64 on CPU (batched central finite differences of the f64 gradient,
~25 s at the auditory size) and writes it to ``<paper-dir>/hessian_f64.npz``
for ``sample_posterior(laplace_hessian=...)``.

A CPU float64 control for the Hessian ``sample_posterior`` computes in
process: an FD Hessian of float32-policy gradients buries the soft
curvatures in gradient noise, while the f64 stencil resolves them, so
NUTS warmup starts from correct scales in every direction.

    python scripts/laplace_hessian.py --paper-dir results/paper_nuts
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper-dir", default="results/paper_nuts")
    ap.add_argument("--ntime", type=int, default=1200)
    ap.add_argument("--ntrials", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fd-step", type=float, default=1e-4)
    args = ap.parse_args()

    out = os.path.join(args.paper_dir, "hessian_f64.npz")
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    assert jax.default_backend() == "cpu", jax.default_backend()

    from scripts.paper_nuts_run import build_model

    model = build_model(args.paper_dir, args.ntime, args.ntrials, args.seed)
    map_path = os.path.join(args.paper_dir, "map_params.pkl")
    with open(map_path, "rb") as f:
        model.restore_model_params(pickle.load(f))
    fns = model._fns()
    Y = model._Y()
    u_map = jnp.asarray(fns.param_set.pack(model._theta()))
    assert u_map.dtype == jnp.float64, u_map.dtype
    dim = u_map.shape[0]

    # Unconstrained f64 mode polish.  The box bounds are the reference's
    # OPTIMIZER guard (scipy L-BFGS-B, ref gpcsd1d.py:193-211), not part of
    # the probability model — the posterior is defined by the priors.  When
    # a bound binds at the box MAP, centering/whitening there puts the
    # Laplace approximation far from the posterior bulk and warmup spends
    # hundreds of transitions drifting out (measured on the round-2 run).
    # Polishing without the box recovers the true mode; for well-specified
    # data the polish is a no-op (the mode is interior).
    from gpcsd_tpu.infer.lbfgs import lbfgs_minimize

    res = jax.jit(
        lambda u: lbfgs_minimize(
            lambda uu: fns.neg_log_joint(uu, Y), u, max_iter=800
        )
    )(u_map)
    u0 = jnp.asarray(res.u)
    f_map = float(fns.neg_log_joint(u_map, Y))
    f_mode = float(np.asarray(res.f))
    moved = float(np.max(np.abs(np.asarray(u0 - u_map))))
    print(
        "mode polish: logp %+.1f -> %+.1f (gain %.1f), max |du| %.3f, "
        "%d iters" % (-f_map, -f_mode, f_map - f_mode, moved,
                      int(np.asarray(res.n_iter))),
        flush=True,
    )
    th_mode = fns.param_set.unpack(u0)
    th_mode = fns.full_theta(th_mode)
    model._set_theta(th_mode)
    mode_path = os.path.join(args.paper_dir, "mode_params.pkl")
    with open(mode_path + ".tmp", "wb") as f:
        pickle.dump(model.extract_model_params(), f)
    os.replace(mode_path + ".tmp", mode_path)

    if os.path.exists(out):
        with np.load(out) as d:
            if np.allclose(d["u0"], np.asarray(u0)):
                print(f"cached: {out}", flush=True)
                return 0

    h = args.fd_step
    eye = h * jnp.eye(dim, dtype=u0.dtype)
    pts = jnp.concatenate([u0[None] + eye, u0[None] - eye], axis=0)
    gs = jax.jit(jax.vmap(jax.grad(lambda u: fns.neg_log_joint(u, Y))))(pts)
    H = np.asarray((gs[:dim] - gs[dim:]) / (2 * h), dtype=np.float64).T
    H = 0.5 * (H + H.T)
    w = np.linalg.eigvalsh(H)
    with open(out + ".tmp", "wb") as f:
        np.savez(f, H=H, u0=np.asarray(u0), eigs=w)
    os.replace(out + ".tmp", out)
    print(
        "wrote %s  (eig range [%.3e, %.3e], %d non-positive)"
        % (out, w.min(), w.max(), int((w <= 0).sum())),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
