"""Auditory-shape benchmarks, measured live on the device JAX finds.

Problem size = the reference's flagship fit
(``auditory_lfp/fit_gpcsd_baseline.py``): nx=24 electrodes, nt=600 time
points, 100 trials, ngl=100 quadrature nodes.

Prints TWO JSON lines, each naming the device it ran on:

1. **log-joint value+grad evals/s** — jitted ``value_and_grad`` vs the
   reference-style numpy float64 *forward-only* log-joint (eigh of Ks/Kt +
   per-trial quad-form loop, mirroring ``gpcsd1d.py:113-128``); a lower
   bound on the true speedup.
2. **NUTS samples/s** — a live run through ``sample_posterior`` on the
   model-family surrogate (:func:`build_nuts_problem`, per-channel noise,
   exact factorization): MAP fit, Laplace whitening from the in-process
   Hessian, dense metric.  The run must pass the sampler-health gates
   (:func:`nuts_gate_failures`); an unhealthy run reports ``value: null``
   and its reasons rather than a degenerate rate.
"""

import json
import time

import numpy as np

NX, NT, NTRIALS, NGL = 24, 600, 100, 100

NUTS_CHAINS = 4
NUTS_WARMUP = NUTS_SAMPLES = 100
NUTS_MAX_DEPTH = 7


def build_problem(seed=0):
    import gpcsd_tpu as g

    rng = np.random.default_rng(seed)
    x = (np.arange(NX) * 100.0).reshape(-1, 1)
    t = np.arange(NT).reshape(-1, 1) * 1.0
    lfp = rng.normal(size=(NX, NT, NTRIALS))
    m = g.GPCSD1D(lfp, x, t, ngl=NGL)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[0].params["sigma2"]["value"] = 1.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    m.temporal_cov_list[1].params["sigma2"]["value"] = 0.5
    m.sig2n["value"] = 0.05
    return m


def bench_ours(m, n_iters=50):
    import jax
    import jax.numpy as jnp

    fns = m._fns()
    Y = m._Y()
    u0 = np.asarray(fns.param_set.pack(m._theta()))

    vg = jax.jit(jax.value_and_grad(fns.neg_log_joint))
    # distinct parameter points so no intermediate is trivially reusable
    us = jnp.asarray(u0[None, :] + 0.01 * np.random.default_rng(1).normal(size=(n_iters, u0.size)))
    f, g = vg(us[0], Y)
    f.block_until_ready()  # compile
    t0 = time.perf_counter()
    for i in range(n_iters):
        f, g = vg(us[i], Y)
    f.block_until_ready()
    dt = time.perf_counter() - t0
    return n_iters / dt


def reference_style_loglik_numpy(theta, x, t, gl_x, gl_w, Y):
    """Reference-semantics forward pass in plain numpy float64:
    quadrature covariances, two eighs, per-trial quad-form loop."""
    R, ell = theta["R"], theta["ell"]
    delta = x[:, None] - gl_x[None, :]
    u = delta / R
    A = gl_w[None, :] * (np.sqrt(u * u + 1) - np.abs(u))
    Kgl = np.exp(-0.5 * ((gl_x[:, None] - gl_x[None, :]) / ell) ** 2)
    Ks = A @ Kgl @ A.T + 1e-8 * np.eye(x.size)
    dt_ = t[:, None] - t[None, :]
    Kt = theta["s1"] * np.exp(-0.5 * (dt_ / theta["l1"]) ** 2) + theta["s2"] * np.exp(
        -np.abs(dt_) / theta["l2"]
    )
    lt, Qt = np.linalg.eigh(Kt)
    ls, Qs = np.linalg.eigh(Ks)
    Dvec = np.repeat(ls, t.size) * np.tile(lt, x.size) + theta["sig2n"]
    logdet = -0.5 * Y.shape[2] * np.sum(np.log(Dvec))
    quad = 0.0
    for trial in range(Y.shape[2]):  # the reference's per-trial loop
        alpha = (Qs.T @ Y[:, :, trial] @ Qt).reshape(-1)
        quad += np.sum(alpha**2 / Dvec)
    return logdet - 0.5 * quad


def bench_baseline(m, n_iters=5):
    from scipy.special import roots_legendre

    x = m.x.reshape(-1)
    t = m.t.reshape(-1)
    glx, glw = roots_legendre(NGL)
    a, b = x.min(), x.max()
    gl_x = 0.5 * (glx + 1) * (b - a) + a
    gl_w = 0.5 * (b - a) * glw
    Y = m.lfp
    thetas = []
    rng = np.random.default_rng(2)
    for _ in range(n_iters):
        j = 1.0 + 0.01 * rng.normal()
        thetas.append(
            dict(R=150.0 * j, ell=200.0 * j, s1=1.0 * j, l1=8.0 * j, s2=0.5 * j,
                 l2=3.0 * j, sig2n=0.05 * j)
        )
    reference_style_loglik_numpy(thetas[0], x, t, gl_x, gl_w, Y)  # warm caches
    t0 = time.perf_counter()
    for th in thetas:
        reference_style_loglik_numpy(th, x, t, gl_x, gl_w, Y)
    dt = time.perf_counter() - t0
    return n_iters / dt


def build_nuts_problem(seed=0, het_noise="approx"):
    """Model-family surrogate at the bench geometry: prior CSD draw ->
    Kronecker LFP covariance -> iid noise, amplitudes scaled so LFP-space
    signal variance ~0.5 vs sig2n 0.01 (the paper's SNR regime).  A NUTS
    rate measured on pure-noise data is degenerate (~1 leapfrog per
    sample), so the benchmark must pose a realistic posterior.

    :param het_noise: ``"exact"`` gives the model one noise variance per
        channel (reference per-channel priors) and the exact noise-whitened
        factorization — the configuration production sampling uses;
        ``"approx"`` keeps a single shared noise variance.
    """
    import gpcsd_tpu as g

    rng = np.random.default_rng(seed)
    x = (np.arange(NX) * 100.0).reshape(-1, 1)
    t = np.arange(NT).reshape(-1, 1) * 1.0
    kw = {}
    if het_noise == "exact":
        kw = dict(sig2n_prior=[g.HalfNormal(0.1) for _ in range(NX)],
                  het_noise="exact")
    m = g.GPCSD1D(np.zeros((NX, NT, NTRIALS)), x, t, ngl=NGL, **kw)
    m.R["value"] = 150.0
    m.spatial_cov.params["ell"]["value"] = 200.0
    m.temporal_cov_list[0].params["ell"]["value"] = 8.0
    m.temporal_cov_list[1].params["ell"]["value"] = 3.0
    fns = m._fns()
    theta = m._theta()
    # unit-sigma2 LFP-space spatial cov through the model's own quadrature
    # convention; rescale so the summed signal variance lands at 0.5
    Ks = np.asarray(fns.build_ks(theta), dtype=np.float64)
    c = float(np.mean(np.diag(Ks)))
    s1, s2, sig2n = 0.35 / c, 0.15 / c, 0.01
    m.temporal_cov_list[0].params["sigma2"]["value"] = s1
    m.temporal_cov_list[1].params["sigma2"]["value"] = s2
    m.sig2n["value"] = np.full(NX, sig2n) if het_noise == "exact" else sig2n
    theta = m._theta()
    Kt = np.asarray(fns.build_kt(theta), dtype=np.float64)
    Ls = np.linalg.cholesky(Ks + 1e-10 * np.trace(Ks) / NX * np.eye(NX))
    Lt = np.linalg.cholesky(Kt + 1e-10 * np.trace(Kt) / NT * np.eye(NT))
    z = rng.normal(size=(NTRIALS, NX, NT))
    lfp = np.einsum("xy,byt,st->xsb", Ls, z, Lt)
    lfp += np.sqrt(sig2n) * rng.normal(size=lfp.shape)
    m.lfp = lfp
    return m


#: generating parameters of :func:`build_nuts_problem` that every restart of
#: :func:`fit_nuts_problem` starts from; the priors draw the rest
NUTS_FIT_START = ("tm0_ell", "tm0_sigma2", "tm1_ell", "tm1_sigma2")


def fit_nuts_problem(m, seed=0, n_restarts=10):
    """MAP fit of a fresh :func:`build_nuts_problem` surrogate, every
    restart started at its generating temporal parameters.

    From prior draws alone, every restart at the auditory shape stops with
    the smooth temporal component's variance at its lower bound (1e-8),
    hundreds of log-units below the generating point: not a mode, so
    Laplace whitening there is wrong and NUTS from it diverges now and
    then (PERF.md).
    """
    theta = m._theta()
    start = {k: np.asarray(theta[k]) for k in NUTS_FIT_START}
    return m.fit(n_restarts=n_restarts, seed=seed,
                 options={"init_overrides": start})


def nuts_gate_failures(steps, accept, n_divergent, max_rhat, max_depth):
    """Sampler-health gate failures (empty = healthy).

    A throughput number from a degenerate sampler (~1 leapfrog per
    transition), a frozen one (every tree at the depth cap, or acceptance
    far off its target), a divergent one, or one whose chains did not mix
    is not a result.  The R-hat bound is loose because the runs are short.
    """
    max_traj = 2 ** (max_depth - 1)
    failures = []
    if not (steps is not None and 4.0 <= steps <= max_traj):
        failures.append(
            "mean leapfrogs/transition %s outside [4, %d]" % (steps, max_traj)
        )
    if not (accept is not None and 0.6 <= accept <= 0.95):
        failures.append("mean acceptance %s outside [0.6, 0.95]" % accept)
    if n_divergent is None or n_divergent > 0:
        failures.append("%s post-warmup divergences" % n_divergent)
    if not (max_rhat is not None and max_rhat < 2.0):
        failures.append("max split-R-hat %s not < 2" % max_rhat)
    return failures


def nuts_health(post, max_depth):
    """Health summary of a ``sample_posterior`` result, gates applied."""
    d = post.diagnostics
    rhats = d.get("rhat", {})
    max_rhat = max((float(np.max(v)) for v in rhats.values()), default=None)
    out = {
        "mean_leapfrogs_per_transition": float(np.mean(d["num_steps"])),
        "mean_acceptance": float(np.mean(d["accept_prob"])),
        "divergences": int(np.sum(d["diverging"])),
        "max_rhat": max_rhat,
    }
    out["gate_failures"] = nuts_gate_failures(
        out["mean_leapfrogs_per_transition"], out["mean_acceptance"],
        out["divergences"], max_rhat, max_depth,
    )
    return out


class CompileTimer:
    """Sums the seconds JAX spends tracing, lowering and compiling inside
    the ``with`` block, so a timed call that compiles can report its
    steady time as wall time minus this."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __enter__(self):
        import jax

        self.seconds = 0.0

        def listen(event, duration, **kwargs):
            if event in self.EVENTS:
                self.seconds += duration

        self._listen = listen
        jax.monitoring.register_event_duration_secs_listener(listen)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._listen)
        return False


def run_nuts(m, mesh=None, seed=5, num_warmup=NUTS_WARMUP,
             num_samples=NUTS_SAMPLES, **kw):
    """One ``sample_posterior`` call with the benchmark's sampler settings;
    returns (posterior, stats).  ``samples_per_s`` charges warmup: it is
    post-warmup draws over the run's wall time less compilation."""
    with CompileTimer() as ct:
        t0 = time.perf_counter()
        post = m.sample_posterior(
            n_chains=NUTS_CHAINS, num_warmup=num_warmup,
            num_samples=num_samples, max_depth=NUTS_MAX_DEPTH,
            dense_mass=True, seed=seed, mesh=mesh, **kw,
        )
        wall = time.perf_counter() - t0
    run_s = wall - ct.seconds
    stats = {
        "num_warmup": num_warmup,
        "num_samples": num_samples,
        "wall_s": wall,
        "compile_s": ct.seconds,
        "samples_per_s": NUTS_CHAINS * num_samples / run_s,
    }
    stats.update(nuts_health(post, NUTS_MAX_DEPTH))
    return post, stats


def device_label():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    m = build_problem()
    ours = bench_ours(m)
    base = bench_baseline(m)
    dev = device_label()
    print(
        json.dumps(
            {
                "metric": "GPCSD1D log-joint value+grad evals/s (nx=24,nt=600,trials=100,ngl=100)",
                "value": round(ours, 3),
                "unit": "evals/s",
                "vs_baseline": round(ours / base, 2),
                "device": dev,
            }
        )
    )
    nm = build_nuts_problem(het_noise="exact")
    fit_nuts_problem(nm)
    _, st = run_nuts(nm)
    healthy = not st["gate_failures"]
    print(
        json.dumps(
            {
                "metric": "NUTS samples/s, auditory surrogate (%d chains x "
                          "(%d+%d), max_depth=%d, dense metric, Laplace "
                          "whitening; warmup charged)"
                          % (NUTS_CHAINS, NUTS_WARMUP, NUTS_SAMPLES,
                             NUTS_MAX_DEPTH),
                "value": round(st["samples_per_s"], 3) if healthy else None,
                "unit": "samples/s",
                "device": dev,
                **{k: st[k] for k in ("compile_s",
                                      "mean_leapfrogs_per_transition",
                                      "mean_acceptance", "divergences",
                                      "max_rhat", "gate_failures")},
            }
        )
    )


if __name__ == "__main__":
    main()
