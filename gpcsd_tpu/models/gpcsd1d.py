"""GPCSD1D: 1D Gaussian-process current source density model.

API-parity target: ``/root/reference/src/gpcsd/gpcsd1d.py`` (class GPCSD1D:
constructor defaults ``:21-62``, ``loglik`` ``:113-128``, ``fit`` ``:130-246``,
``predict`` ``:248-293``, ``sample_prior`` ``:295-309``, param round-trip
``:84-102``, ``update_lfp`` ``:104-111``).  The numerical engine underneath is
the functional core in :mod:`gpcsd_tpu.models.core` — pure jitted functions,
batched trials, factored Kronecker algebra, vmapped restarts.

Data layout: the constructor takes the reference's ``(nx, nt, ntrials)`` LFP
array and stores a batch-leading ``(ntrials, nx, nt)`` copy internally.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import kronlik
from ..ops.kernels import se as _se_kernel
from .core import ModelFns, make_model_fns, posterior_predict
from .covariances import (
    GPCSD1DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
)
from .params import ParamSet, ParamSpec
from .inference_api import InferenceAPIMixin
from .priors import HalfNormal, InvGamma
from ..infer.map import map_fit

JITTER = config.JITTER_1D


class GPCSD1D(InferenceAPIMixin):
    def __init__(
        self,
        lfp,
        x,
        t,
        a=None,
        b=None,
        ngl=100,
        spatial_cov=None,
        temporal_cov_list=None,
        R_prior=None,
        sig2n_prior=None,
        het_noise="approx",
    ):
        """
        :param lfp: LFP array, shape (n_spatial, n_time, n_trials)
        :param x: observed spatial locations (n_spatial, 1), microns
        :param t: observed time points (n_time, 1), milliseconds
        :param a, b: integration bounds (default min/max of x)
        :param ngl: Gauss-Legendre order (default 100)
        :param spatial_cov: GPCSD1DSpatialCovSE instance (default built here)
        :param temporal_cov_list: list of temporal covariance objects
            (default [SE, Matern], matching the reference)
        :param R_prior: prior for R (default InvGamma from electrode geometry)
        :param sig2n_prior: prior for noise variance — a single prior for
            scalar noise or a list for per-channel noise
        :param het_noise: per-channel-noise likelihood mode: "approx"
            reproduces the reference's eigenbasis approximation
            (``utility_functions.py:54-63``, SURVEY.md §5), "exact" uses the
            noise-whitened exact factorization at identical cost.  Ignored
            for scalar noise (both are exact there).
        """
        if het_noise not in ("approx", "exact"):
            raise ValueError(f"het_noise must be 'approx' or 'exact', got {het_noise!r}")
        self.het_noise = het_noise
        lfp = np.asarray(lfp, dtype=np.float64)
        if lfp.ndim == 2:
            lfp = lfp[:, :, None]
        self.lfp = lfp
        self.x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        xf = self.x.reshape(-1)
        self.a = float(np.min(xf)) if a is None else float(a)
        self.b = float(np.max(xf)) if b is None else float(b)
        self.ngl = int(ngl)
        if spatial_cov is None:
            spatial_cov = GPCSD1DSpatialCovSE(self.x, a=self.a, b=self.b, ngl=self.ngl)
        self.spatial_cov = spatial_cov
        if temporal_cov_list is None:
            temporal_cov_list = [GPCSDTemporalCovSE(self.t), GPCSDTemporalCovMatern(self.t)]
        self.temporal_cov_list = temporal_cov_list
        from .covariances import _interval_prior, _prior_draw

        if R_prior is None:
            R_prior = _interval_prior(
                float(np.min(np.diff(xf))), 0.5 * float(np.max(xf) - np.min(xf))
            )

        self.R = {
            "value": _prior_draw(R_prior),
            "prior": R_prior,
            "min": 0.5 * float(np.min(np.diff(xf))),
            "max": 0.8 * float(np.max(xf) - np.min(xf)),
        }
        if sig2n_prior is None:
            sig2n_prior = HalfNormal(0.1)
            self.sig2n = {
                "value": _prior_draw(sig2n_prior),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 0.5,
            }
        elif isinstance(sig2n_prior, list):
            self.sig2n = {
                "value": np.array([_prior_draw(sp) for sp in sig2n_prior]),
                "prior": sig2n_prior,
                "min": [1e-8] * len(sig2n_prior),
                "max": [0.5] * len(sig2n_prior),
            }
        else:
            self.sig2n = {
                "value": _prior_draw(sig2n_prior),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 0.5,
            }

    # ------------------------------------------------------------------ API

    def __str__(self):
        s = "GPCSD1D object\n"
        s += "LFP shape: (%d, %d, %d)\n" % self.lfp.shape
        s += "Integration bounds: (%d, %d)\n" % (self.a, self.b)
        s += "Integration number points: %d\n" % self.ngl
        s += "R parameter prior: %s\n" % str(self.R["prior"])
        s += "R parameter value %0.4g\n" % self.R["value"]
        s += "Spatial covariance ell prior: %s\n" % str(
            self.spatial_cov.params["ell"]["prior"]
        )
        s += "Spatial covariance ell value %0.4g\n" % self.spatial_cov.params["ell"]["value"]
        for i, tc in enumerate(self.temporal_cov_list):
            s += "Temporal covariance %d class name: %s\n" % (i + 1, type(tc).__name__)
            s += "Temporal covariance %d ell prior: %s\n" % (i + 1, str(tc.params["ell"]["prior"]))
            s += "Temporal covariance %d ell value %0.4g\n" % (i + 1, tc.params["ell"]["value"])
            s += "Temporal covariance %d sigma2 prior: %s\n" % (
                i + 1,
                str(tc.params["sigma2"]["prior"]),
            )
            s += "Temporal covariance %d sigma2 value %0.4g\n" % (
                i + 1,
                tc.params["sigma2"]["value"],
            )
        return s

    def extract_model_params(self):
        """Reference-schema param dict (pickle-compatible, ``gpcsd1d.py:84-91``)."""
        return {
            "R": self.R["value"],
            "sig2n": self.sig2n["value"],
            "spatial_ell": self.spatial_cov.params["ell"]["value"],
            "temporal_ell_list": [tc.params["ell"]["value"] for tc in self.temporal_cov_list],
            "temporal_sigma2_list": [
                tc.params["sigma2"]["value"] for tc in self.temporal_cov_list
            ],
        }

    def restore_model_params(self, params):
        self.R["value"] = params["R"]
        self.sig2n["value"] = params["sig2n"]
        self.spatial_cov.params["ell"]["value"] = params["spatial_ell"]
        if len(self.temporal_cov_list) != len(params["temporal_ell_list"]):
            raise ValueError("different number of temporal covariance functions!")
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = params["temporal_ell_list"][i]
            tc.params["sigma2"]["value"] = params["temporal_sigma2_list"][i]

    def update_lfp(self, new_lfp, t, x=None):
        if x is not None:
            self.x = np.asarray(x, dtype=np.float64).reshape(-1, 1)
            self.spatial_cov.x = self.x
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        for tc in self.temporal_cov_list:
            tc.t = self.t
        lfp = np.asarray(new_lfp, dtype=np.float64)
        if lfp.ndim == 2:
            lfp = lfp[:, :, None]
        self.lfp = lfp
        self._fns_cache = {}

    # ------------------------------------------------------- functional core

    @property
    def _sig2n_size(self):
        v = np.asarray(self.sig2n["value"])
        return int(v.size) if v.ndim else 1

    @property
    def _sig2n_is_vector(self):
        return np.asarray(self.sig2n["value"]).ndim > 0

    def _theta(self):
        """Current constrained parameter values as a flat-named dict."""
        theta = {
            "R": jnp.asarray(self.R["value"]),
            "ell": jnp.asarray(self.spatial_cov.params["ell"]["value"]),
        }
        for i, tc in enumerate(self.temporal_cov_list):
            theta[f"tm{i}_ell"] = jnp.asarray(tc.params["ell"]["value"])
            theta[f"tm{i}_sigma2"] = jnp.asarray(tc.params["sigma2"]["value"])
        theta["sig2n"] = jnp.asarray(self.sig2n["value"])
        return theta

    def _set_theta(self, theta):
        self.R["value"] = float(theta["R"])
        self.spatial_cov.params["ell"]["value"] = float(theta["ell"])
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = float(theta[f"tm{i}_ell"])
            tc.params["sigma2"]["value"] = float(theta[f"tm{i}_sigma2"])
        s = np.asarray(theta["sig2n"])
        self.sig2n["value"] = s if s.ndim else float(s)

    def _param_set(self, fix_R=False) -> ParamSet:
        """Parameter order matches the reference tparams vector
        (``gpcsd1d.py:137-151``): R, spatial ell, per-temporal (ell, sigma2),
        sig2n; R and spatial ell carry the /100 scaling convention."""
        specs = {}
        if not fix_R:
            specs["R"] = ParamSpec(
                prior=self.R["prior"], lo=self.R["min"], hi=self.R["max"], scale=100.0
            )
        sp = self.spatial_cov.params["ell"]
        specs["ell"] = ParamSpec(prior=sp["prior"], lo=sp["min"], hi=sp["max"], scale=100.0)
        for i, tc in enumerate(self.temporal_cov_list):
            pe, ps2 = tc.params["ell"], tc.params["sigma2"]
            specs[f"tm{i}_ell"] = ParamSpec(prior=pe["prior"], lo=pe["min"], hi=pe["max"])
            specs[f"tm{i}_sigma2"] = ParamSpec(
                prior=ps2["prior"], lo=max(ps2["min"], 1e-300), hi=ps2["max"]
            )
        if self._sig2n_is_vector:
            specs["sig2n"] = ParamSpec(
                prior=tuple(self.sig2n["prior"]),
                lo=np.asarray(self.sig2n["min"]),
                hi=np.asarray(self.sig2n["max"]),
                size=self._sig2n_size,
            )
        else:
            specs["sig2n"] = ParamSpec(
                prior=self.sig2n["prior"], lo=self.sig2n["min"], hi=self.sig2n["max"]
            )
        return ParamSet(specs)

    def _fns(self, fix_R=False, precondition=False) -> ModelFns:
        cache = getattr(self, "_fns_cache", None)
        if cache is None:
            cache = self._fns_cache = {}
        pre_key = None
        if precondition:
            pre_key = tuple(
                round(float(np.asarray(v).ravel()[0]), 10) for v in self._theta().values()
            )
        # include the numeric-policy fields make_model_fns reads at build
        # time so set_policy(...) invalidates cached fns automatically
        from ..config import get_policy

        pol = get_policy()
        keyt = (fix_R, pre_key, self.het_noise, self.lfp.shape, self.t.shape[0], float(self.t[0, 0]), float(self.t[-1, 0]),
                str(pol.factor_dtype), bool(pol.spatial_precondition))
        if keyt in cache:
            return cache[keyt]
        sc = self.spatial_cov
        x = jnp.asarray(self.x.reshape(-1))
        gl_x = jnp.asarray(sc.gl_x)
        gl_w = jnp.asarray(sc.gl_w)
        nx = x.shape[0]
        jitter_eye = JITTER * jnp.eye(nx)
        from ..ops.spatial import kphi_1d

        def build_ks(theta):
            return kphi_1d(x, gl_x, gl_w, theta["ell"], theta["R"]) + jitter_eye

        kinds = tuple(tc.kind for tc in self.temporal_cov_list)
        pset = self._param_set(fix_R=fix_R)
        fixed = {}
        fixed_lp = 0.0
        if fix_R:
            fixed["R"] = jnp.asarray(self.R["value"])
            fixed_lp = float(self.R["prior"].lpdf(self.R["value"]))
        fns = make_model_fns(
            pset, build_ks, kinds, self.t.reshape(-1), fixed=fixed, fixed_log_prior=fixed_lp,
            precondition=self._theta() if precondition else None,
            het_exact=self.het_noise == "exact",
        )
        cache[keyt] = fns
        return fns

    def _Y(self):
        """(ntrials, nx, nt) trial batch."""
        return jnp.asarray(np.moveaxis(self.lfp, 2, 0))

    # ------------------------------------------------------------- inference

    def loglik(self):
        """Marginal log likelihood at the current parameter values."""
        fns = self._fns()
        return float(jax.jit(fns.loglik)(self._theta(), self._Y()))

    def fit(
        self,
        n_restarts=10,
        method="L-BFGS-B",
        fix_R=False,
        verbose=False,
        backend="jax",
        seed=0,
        options=None,
    ):
        """Multi-restart MAP fit; writes the best parameters back in place.

        :param backend: 'jax' (vmapped restarts on the device) or 'scipy'
            (serial L-BFGS-B, reference-parity path).
        :param options: passed to :func:`~gpcsd_tpu.infer.map.map_fit`:
            ``maxiter``, ``gtol``, ``ftol``, ``chunk_iters``, ``state_path``,
            ``max_wall_seconds`` and ``init_overrides`` (constrained values
            every restart starts from; the priors draw the rest).
        """
        del method  # only L-BFGS variants are supported, as in the reference
        options = options or {}
        fns = self._fns(fix_R=fix_R)
        res = map_fit(
            fns.neg_log_joint,
            fns.param_set,
            self._Y(),
            jax.random.PRNGKey(seed),
            n_restarts=n_restarts,
            backend=backend,
            maxiter=options.get("maxiter", 1000),
            gtol=options.get("gtol", 1e-5),
            ftol=options.get("ftol", 1e7 * np.finfo(float).eps),
            verbose=verbose,
            chunk_iters=options.get("chunk_iters"),
            state_path=options.get("state_path"),
            max_wall_seconds=options.get("max_wall_seconds"),
            init_overrides=options.get("init_overrides"),
        )
        theta = fns.param_set.unpack(jnp.asarray(res.u_best))
        if fix_R:
            theta["R"] = jnp.asarray(self.R["value"])
        self._set_theta(theta)
        self.fit_result = res
        return res

    def predict(self, z, t, type="csd"):
        """Posterior mean CSD/LFP at locations z and times t.

        Sets ``csd_pred``/``csd_pred_list`` (and/or ``lfp_pred``...) in the
        reference's (nz, ntstar, ntrials) layout and also returns them.
        """
        z = np.asarray(z, dtype=np.float64).reshape(-1, 1)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov

        kphig = kphi = None
        if type in ("both", "csd"):
            kphig = sc.compKphig_1d(z, theta["R"])
        if type in ("both", "lfp"):
            kphi = sc.compKphi_1d(theta["R"], xp=z)

        out = posterior_predict(
            fns,
            theta,
            self._Y(),
            kphig=kphig,
            kphi=kphi,
            t_data=self.t.reshape(-1),
            t_star=tstar.reshape(-1),
        )
        if "csd" in out:
            total, comps = out["csd"]
            self.csd_pred = np.moveaxis(np.asarray(total), 0, 2)
            self.csd_pred_list = [np.moveaxis(np.asarray(c), 0, 2) for c in comps]
        if "lfp" in out:
            total, comps = out["lfp"]
            self.lfp_pred = np.moveaxis(np.asarray(total), 0, 2)
            self.lfp_pred_list = [np.moveaxis(np.asarray(c), 0, 2) for c in comps]
        self.t_pred = tstar
        self.x_pred = z
        return self.csd_pred if type in ("both", "csd") else self.lfp_pred

    def predict_variance(self, z, t, type="csd"):
        """Pointwise posterior variance of the CSD (or LFP) at (z, t) —
        uncertainty the reference cannot produce (means only).  Returns an
        (nz, ntstar) array; fully factored (see ``core.posterior_variance``).
        """
        from .core import posterior_variance

        z = np.asarray(z, dtype=np.float64).reshape(-1, 1)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1)
        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov
        if type == "csd":
            kxz = sc.compKphig_1d(z, theta["R"])
            prior_diag = jnp.ones(z.shape[0])  # SE correlation: k(z,z)=1
        elif type == "lfp":
            kxz = sc.compKphi_1d(theta["R"], xp=z)
            from ..ops.spatial import kphi_1d

            prior_diag = jnp.diagonal(
                kphi_1d(z.reshape(-1), jnp.asarray(sc.gl_x), jnp.asarray(sc.gl_w),
                        theta["ell"], theta["R"])
            )
        else:
            raise ValueError(type)
        var = posterior_variance(
            fns, theta, kxz, prior_diag, self.t.reshape(-1), tstar
        )
        return np.asarray(var)

    def predict_samples(self, z, t, n_draws=20, seed=0, trial=0,
                        method="auto", n_features=2048):
        """Posterior CSD *samples* at (z, t) for one trial via Matheron's
        rule (pathwise conditioning) — full posterior uncertainty, another
        capability beyond the reference's point predictions.

        Draw (c*, y') jointly from the prior — the CSD on the union grid
        z ∪ (GL nodes), pushed through the quadrature operator A plus noise
        for y' — then correct: ``c* + Kzy K_yy^{-1} (y - y')``.  Everything
        stays factored (Cholesky of small spatial blocks, Kronecker solves).
        Arbitrary prediction times are supported: the joint prior is drawn
        on the union time grid t* ∪ t_data (separable, so one temporal
        Cholesky of size nt* + nt covers both blocks).

        :param method: spatial prior-draw factor — "exact" (Cholesky of the
            union kernel), "rff" (random Fourier features, scalable; the
            posterior correction stays exact so only the prior carries the
            O(1/sqrt(n_features)) kernel approximation), or "auto" (exact
            below ~2000 union points, rff above).
        :param n_features: number of random features for method="rff".
        :return: (n_draws, nz, ntstar)
        """
        z = np.asarray(z, dtype=np.float64).reshape(-1)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1)
        t_data = self.t.reshape(-1)
        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov
        nz = z.size
        ngl = sc.gl_x.size
        nt = t_data.size
        nts = tstar.size

        from ..ops.kernels import se as _se
        from ..ops.spatial import quad_weights_1d

        key = jax.random.PRNGKey(seed)
        union = jnp.concatenate([jnp.asarray(z), jnp.asarray(sc.gl_x)])
        if method == "auto":
            method = "rff" if nz + ngl > 2000 else "exact"
        if method == "exact":
            K_un = _se(union, union, theta["ell"])
            Ls = jnp.linalg.cholesky(K_un + 1e-7 * jnp.eye(nz + ngl))
        elif method == "rff":
            from ..ops.rff import se_rff_features

            Ls = se_rff_features(
                jax.random.fold_in(key, 2), union, theta["ell"], n_features
            )
        else:
            raise ValueError(f"unknown method {method!r}")
        n_latent = Ls.shape[1]
        same_grid = np.array_equal(tstar, t_data)
        if same_grid:
            t_union = t_data
            sl_star, sl_data = slice(0, nt), slice(0, nt)
            jit_t = 1e-10
        else:
            # union time grid; relative jitter keeps the Cholesky stable even
            # when t* overlaps data times (exactly duplicated rows)
            t_union = np.concatenate([tstar, t_data])
            sl_star, sl_data = slice(0, nts), slice(nts, nts + nt)
            jit_t = None
        Kt_u = fns.build_kt(theta, t=t_union, tprime=t_union)
        if jit_t is None:
            jit_t = 1e-8 * jnp.mean(jnp.diagonal(Kt_u)) + 1e-12
        Lt = jnp.linalg.cholesky(Kt_u + jit_t * jnp.eye(t_union.size))
        A = quad_weights_1d(self.x.reshape(-1), sc.gl_x, sc.gl_w, theta["R"])

        eps = jax.random.normal(key, (n_draws, n_latent, t_union.size), Ls.dtype)
        prior_fields = jnp.einsum("xy,byt,st->bxs", Ls, eps, Lt)
        c_star = prior_fields[:, :nz, sl_star]  # CSD prior draws at (z, t*)
        csd_gl = prior_fields[:, nz:, sl_data]  # CSD at (GL nodes, t_data)
        noise = jnp.sqrt(jnp.atleast_1d(theta["sig2n"]))[:, None] * jax.random.normal(
            jax.random.fold_in(key, 1), (n_draws, self.x.shape[0], nt), Ls.dtype
        )
        y_prior = jnp.einsum("xg,bgt->bxt", A, csd_gl) + noise

        fac = fns.build_factors(theta)
        y_obs = self._Y()[trial]
        resid = y_obs[None] - y_prior  # (n_draws, nx, nt)
        V = kronlik.kron_solve(fac, resid)
        Kphig = jnp.asarray(sc.compKphig_1d(z.reshape(-1, 1), theta["R"]))
        Kt_cross = fns.build_kt(theta, t=t_data, tprime=tstar)  # (nt, nts)
        correction = kronlik.kron_cross_mean(Kphig, Kt_cross, V)
        return np.asarray(c_star + correction)

    def sample_prior(self, ntrials, seed=0):
        """Draw CSD prior samples, (nx, nt, ntrials) (``gpcsd1d.py:295-309``)."""
        fns = self._fns()
        theta = self._theta()
        Ks_csd = _se_kernel(self.x, self.x, theta["ell"])
        Kt = fns.build_kt(theta)
        nx, nt = Ks_csd.shape[0], Kt.shape[0]
        Ls = jnp.linalg.cholesky(Ks_csd + JITTER * jnp.eye(nx))
        Lt = jnp.linalg.cholesky(Kt)
        z = jax.random.normal(jax.random.PRNGKey(seed), (ntrials, nx, nt), dtype=Ls.dtype)
        csd = jnp.einsum("xy,byt,st->bxs", Ls, z, Lt)
        return np.moveaxis(np.asarray(csd), 0, 2)
