"""GPCSD2D: 2D (planar probe) Gaussian-process CSD model.

API-parity target: ``/root/reference/src/gpcsd/gpcsd2d.py`` (constructor
defaults ``:20-79``, ``loglik`` ``:136-151``, ``fit`` ``:153-287``,
``predict`` ``:289-334``, ``sample_prior`` ``:336-360``, param round-trip
``:103-125``).  Same functional engine as GPCSD1D; differences are the
product-SE spatial covariance with two lengthscales, the singularity offset
``eps``, jitter 1e-7, and sig2n bounds (max 10).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops.kernels import se_2d as _se2d_kernel
from ..utils.grids import reduce_grid
from .core import ModelFns, make_model_fns, posterior_predict
from .covariances import (
    GPCSD2DSpatialCovSE,
    GPCSDTemporalCovMatern,
    GPCSDTemporalCovSE,
    _prior_draw,
)
from .params import ParamSet, ParamSpec
from .inference_api import InferenceAPIMixin
from .priors import HalfNormal, InvGamma
from ..infer.map import map_fit

JITTER = config.JITTER_2D


class GPCSD2D(InferenceAPIMixin):
    def __init__(
        self,
        lfp,
        x,
        t,
        a1=None,
        b1=None,
        a2=None,
        b2=None,
        ngl1=20,
        ngl2=60,
        spatial_cov=None,
        temporal_cov_list=None,
        R_prior=None,
        sig2n_prior=None,
        eps=None,
        het_noise="approx",
    ):
        """
        :param lfp: LFP array, shape (n_spatial_lfp, n_time, n_trials)
        :param x: observed spatial locations (n_spatial_lfp, 2), microns
        :param t: observed time points (n_time, 1), milliseconds
        :param a1,b1,a2,b2: integration bounds per dimension (default data range)
        :param ngl1, ngl2: Gauss-Legendre orders per dimension
        :param eps: forward-model singularity offset (default 5*min spacing)
        :param het_noise: per-channel-noise likelihood mode — "approx"
            (reference parity, SURVEY.md §5) or "exact" (noise-whitened
            factorization); ignored for scalar noise
        """
        if het_noise not in ("approx", "exact"):
            raise ValueError(f"het_noise must be 'approx' or 'exact', got {het_noise!r}")
        self.het_noise = het_noise
        lfp = np.asarray(lfp, dtype=np.float64)
        if lfp.ndim == 2:
            lfp = lfp[:, :, None]
        self.lfp = lfp
        self.x = np.asarray(x, dtype=np.float64)
        self.t = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        if a1 is None:
            a1 = float(np.min(self.x[:, 0]))
        if b1 is None:
            b1 = float(np.max(self.x[:, 0]))
        if a2 is None:
            a2 = float(np.min(self.x[:, 1]))
        if b2 is None:
            b2 = float(np.max(self.x[:, 1]))
        self.a1, self.b1, self.a2, self.b2 = a1, b1, a2, b2
        self.ngl1, self.ngl2 = int(ngl1), int(ngl2)
        if spatial_cov is None:
            spatial_cov = GPCSD2DSpatialCovSE(
                self.x, a1=a1, b1=b1, a2=a2, b2=b2, ngl1=self.ngl1, ngl2=self.ngl2
            )
        self.spatial_cov = spatial_cov
        if temporal_cov_list is None:
            temporal_cov_list = [GPCSDTemporalCovSE(self.t), GPCSDTemporalCovMatern(self.t)]
        self.temporal_cov_list = temporal_cov_list
        x1, x2 = reduce_grid(self.x)
        min_delta_x = float(min(np.min(np.diff(x1)), np.min(np.diff(x2))))
        max_delta_x = float(max(b1 - a1, b2 - a2))
        if R_prior is None:
            from .covariances import _interval_prior

            R_prior = _interval_prior(min_delta_x, 0.5 * max_delta_x)
        self.R = {
            "value": _prior_draw(R_prior),
            "prior": R_prior,
            "min": 0.5 * min_delta_x,
            "max": 0.8 * max_delta_x,
        }
        self.eps = float(5 * min_delta_x) if eps is None else float(eps)
        if sig2n_prior is None:
            sig2n_prior = HalfNormal(1.0)
            self.sig2n = {
                "value": _prior_draw(sig2n_prior),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 10.0,
            }
        elif isinstance(sig2n_prior, list):
            self.sig2n = {
                "value": np.array([_prior_draw(sp) for sp in sig2n_prior]),
                "prior": sig2n_prior,
                "min": [1e-8] * len(sig2n_prior),
                "max": [10.0] * len(sig2n_prior),
            }
        else:
            self.sig2n = {
                "value": _prior_draw(sig2n_prior),
                "prior": sig2n_prior,
                "min": 1e-8,
                "max": 10.0,
            }

    # ------------------------------------------------------------------ API

    def __str__(self):
        s = "GPCSD2D object\n"
        s += "LFP shape: (%d, %d, %d)\n" % self.lfp.shape
        s += "Integration bounds: (%d, %d), (%d, %d)\n" % (self.a1, self.b1, self.a2, self.b2)
        s += "Integration number points: %d, %d\n" % (self.ngl1, self.ngl2)
        s += "R parameter prior: %s\n" % str(self.R["prior"])
        s += "R parameter value %0.4g\n" % self.R["value"]
        for dim in ("ell1", "ell2"):
            s += "Spatial covariance %s prior: %s\n" % (dim, str(self.spatial_cov.params[dim]["prior"]))
            s += "Spatial covariance %s value %0.4g\n" % (dim, self.spatial_cov.params[dim]["value"])
        for i, tc in enumerate(self.temporal_cov_list):
            s += "Temporal covariance %d class name: %s\n" % (i + 1, type(tc).__name__)
            s += "Temporal covariance %d ell value %0.4g\n" % (i + 1, tc.params["ell"]["value"])
            s += "Temporal covariance %d sigma2 value %0.4g\n" % (i + 1, tc.params["sigma2"]["value"])
        return s

    def extract_model_params(self):
        """Reference-schema param dict (``gpcsd2d.py:103-113``)."""
        return {
            "R": self.R["value"],
            "eps": self.eps,
            "sig2n": self.sig2n["value"],
            "spatial_ell1": self.spatial_cov.params["ell1"]["value"],
            "spatial_ell2": self.spatial_cov.params["ell2"]["value"],
            "temporal_ell_list": [tc.params["ell"]["value"] for tc in self.temporal_cov_list],
            "temporal_sigma2_list": [
                tc.params["sigma2"]["value"] for tc in self.temporal_cov_list
            ],
        }

    def restore_model_params(self, params):
        self.R["value"] = params["R"]
        self.eps = params["eps"]
        self.sig2n["value"] = params["sig2n"]
        self.spatial_cov.params["ell1"]["value"] = params["spatial_ell1"]
        self.spatial_cov.params["ell2"]["value"] = params["spatial_ell2"]
        if len(self.temporal_cov_list) != len(params["temporal_ell_list"]):
            raise ValueError("different number of temporal covariance functions!")
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = params["temporal_ell_list"][i]
            tc.params["sigma2"]["value"] = params["temporal_sigma2_list"][i]

    def update_lfp(self, new_lfp, t, x=None):
        if x is not None:
            self.x = np.asarray(x, dtype=np.float64)
            self.spatial_cov.reset_x(self.x)
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
    def _sig2n_is_vector(self):
        return np.asarray(self.sig2n["value"]).ndim > 0

    def _theta(self):
        theta = {
            "R": jnp.asarray(self.R["value"]),
            "ell1": jnp.asarray(self.spatial_cov.params["ell1"]["value"]),
            "ell2": jnp.asarray(self.spatial_cov.params["ell2"]["value"]),
        }
        for i, tc in enumerate(self.temporal_cov_list):
            theta[f"tm{i}_ell"] = jnp.asarray(tc.params["ell"]["value"])
            theta[f"tm{i}_sigma2"] = jnp.asarray(tc.params["sigma2"]["value"])
        theta["sig2n"] = jnp.asarray(self.sig2n["value"])
        return theta

    def _set_theta(self, theta):
        self.R["value"] = float(theta["R"])
        self.spatial_cov.params["ell1"]["value"] = float(theta["ell1"])
        self.spatial_cov.params["ell2"]["value"] = float(theta["ell2"])
        for i, tc in enumerate(self.temporal_cov_list):
            tc.params["ell"]["value"] = float(theta[f"tm{i}_ell"])
            tc.params["sigma2"]["value"] = float(theta[f"tm{i}_sigma2"])
        s = np.asarray(theta["sig2n"])
        self.sig2n["value"] = s if s.ndim else float(s)

    def _param_set(self, fix_R=False) -> ParamSet:
        """tparams order matches reference ``gpcsd2d.py:161-175``:
        R, ell1, ell2, per-temporal (ell, sigma2), sig2n."""
        specs = {}
        if not fix_R:
            specs["R"] = ParamSpec(
                prior=self.R["prior"], lo=self.R["min"], hi=self.R["max"], scale=100.0
            )
        for dim in ("ell1", "ell2"):
            p = self.spatial_cov.params[dim]
            specs[dim] = ParamSpec(prior=p["prior"], lo=p["min"], hi=p["max"], scale=100.0)
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
                size=int(np.asarray(self.sig2n["value"]).size),
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
        delta_w = jnp.asarray(sc.delta_w)
        gl_xy = jnp.asarray(sc.gl_x_grid)
        gl_w = jnp.asarray(sc.gl_w_prod)
        eps = self.eps
        nx = self.x.shape[0]
        jitter_eye = JITTER * jnp.eye(nx)
        from ..ops.spatial import kphi_2d

        def build_ks(theta):
            return (
                kphi_2d(delta_w, gl_xy, gl_w, theta["ell1"], theta["ell2"], theta["R"], eps)
                + jitter_eye
            )

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
        return jnp.asarray(np.moveaxis(self.lfp, 2, 0))

    # ------------------------------------------------------------- inference

    def loglik(self):
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
        profile=False,
        options=None,
    ):
        """Multi-restart MAP fit (reference default maxiter=500,
        ``gpcsd2d.py:153-154``).

        :param profile: if True, profile one objective+gradient evaluation
            with jax.profiler instead of fitting (reference cProfile hook,
            ``gpcsd2d.py:242-247``).
        """
        del method
        options = options or {}
        fns = self._fns(fix_R=fix_R)
        if profile:
            import cProfile

            u0 = fns.param_set.pack(fns.param_set.sample(jax.random.PRNGKey(seed)))
            f = jax.jit(lambda u: fns.neg_log_joint(u, self._Y()))
            gf = jax.jit(jax.grad(lambda u: fns.neg_log_joint(u, self._Y())))
            f(u0).block_until_ready()  # compile outside the profile
            gf(u0).block_until_ready()
            cProfile.runctx("f(u0).block_until_ready()", None, locals(), filename="objfunstats")
            cProfile.runctx("gf(u0).block_until_ready()", None, locals(), filename="gradobjfunstats")
            return None
        res = map_fit(
            fns.neg_log_joint,
            fns.param_set,
            self._Y(),
            jax.random.PRNGKey(seed),
            n_restarts=n_restarts,
            backend=backend,
            maxiter=options.get("maxiter", 500),
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
        """Posterior mean CSD/LFP at (nz, 2) locations z and times t."""
        z = np.asarray(z, dtype=np.float64)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1, 1)
        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov

        kphig = kphi = None
        if type in ("both", "csd"):
            kphig = sc.compKphig_2d(z, theta["R"], self.eps)
        if type in ("both", "lfp"):
            kphi = sc.compKphi_2d(theta["R"], self.eps, xp=z)

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
        """Pointwise posterior variance at (nz, 2) locations z and times t;
        (nz, ntstar).  Capability beyond the reference (means only)."""
        from .core import posterior_variance
        from ..ops import spatial as sp_ops

        z = np.asarray(z, dtype=np.float64)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1)
        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov
        if type == "csd":
            kxz = sc.compKphig_2d(z, theta["R"], self.eps)
            prior_diag = jnp.ones(z.shape[0])  # product-SE correlation
        elif type == "lfp":
            kxz = sc.compKphi_2d(theta["R"], self.eps, xp=z)
            dwz = sp_ops.pairwise_w(z, sc.gl_x_grid)
            kphi_zz = sp_ops.kphi_2d(
                dwz, jnp.asarray(sc.gl_x_grid), jnp.asarray(sc.gl_w_prod),
                theta["ell1"], theta["ell2"], theta["R"], self.eps,
            )
            prior_diag = jnp.diagonal(kphi_zz)
        else:
            raise ValueError(type)
        var = posterior_variance(
            fns, theta, kxz, prior_diag, self.t.reshape(-1), tstar
        )
        return np.asarray(var)

    def predict_samples(self, z, t, n_draws=20, seed=0, trial=0,
                        method="auto", n_features=2048):
        """Posterior CSD samples at (nz, 2) locations z via Matheron's rule
        (see GPCSD1D.predict_samples).  method="exact" builds a Cholesky on
        the z-union-quadrature grid; method="rff" (automatic above ~2000
        union points — e.g. the Neuropixels ngl 30x120 configuration) draws
        the prior through a random-Fourier-feature expansion of the product
        SE kernel, keeping the posterior correction exact.

        :return: (n_draws, nz, ntstar)
        """
        z = np.asarray(z, dtype=np.float64)
        tstar = np.asarray(t, dtype=np.float64).reshape(-1)
        t_data = self.t.reshape(-1)
        from ..ops import kronlik
        from ..ops.kernels import se_2d as _se2d
        from ..ops.spatial import quad_weights_2d

        fns = self._fns()
        theta = self._theta()
        sc = self.spatial_cov
        nz = z.shape[0]
        ngl = sc.gl_x_grid.shape[0]
        nt = t_data.size
        nts = tstar.size

        key = jax.random.PRNGKey(seed)
        union = jnp.concatenate([jnp.asarray(z), jnp.asarray(sc.gl_x_grid)], axis=0)
        if method == "auto":
            method = "rff" if nz + ngl > 2000 else "exact"
        if method == "exact":
            K_un = _se2d(union, union, theta["ell1"], theta["ell2"])
            Ls = jnp.linalg.cholesky(K_un + 1e-6 * jnp.eye(nz + ngl))
        elif method == "rff":
            from ..ops.rff import se_rff_features

            Ls = se_rff_features(
                jax.random.fold_in(key, 2), union,
                jnp.stack([jnp.asarray(theta["ell1"]), jnp.asarray(theta["ell2"])]),
                n_features,
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
            # joint prior over the union time grid (see GPCSD1D.predict_samples)
            t_union = np.concatenate([tstar, t_data])
            sl_star, sl_data = slice(0, nts), slice(nts, nts + nt)
            jit_t = None
        Kt_u = fns.build_kt(theta, t=t_union, tprime=t_union)
        if jit_t is None:
            jit_t = 1e-8 * jnp.mean(jnp.diagonal(Kt_u)) + 1e-12
        Lt = jnp.linalg.cholesky(Kt_u + jit_t * jnp.eye(t_union.size))
        A = quad_weights_2d(jnp.asarray(sc.delta_w), jnp.asarray(sc.gl_w_prod),
                            theta["R"], self.eps)

        eps_n = jax.random.normal(key, (n_draws, n_latent, t_union.size), Ls.dtype)
        prior_fields = jnp.einsum("xy,byt,st->bxs", Ls, eps_n, Lt)
        c_star = prior_fields[:, :nz, sl_star]
        csd_gl = prior_fields[:, nz:, sl_data]
        noise = jnp.sqrt(jnp.atleast_1d(theta["sig2n"]))[:, None] * jax.random.normal(
            jax.random.fold_in(key, 1), (n_draws, self.x.shape[0], nt), Ls.dtype
        )
        y_prior = jnp.einsum("xg,bgt->bxt", A, csd_gl) + noise

        fac = fns.build_factors(theta)
        y_obs = self._Y()[trial]
        V = kronlik.kron_solve(fac, y_obs[None] - y_prior)
        Kphig = jnp.asarray(sc.compKphig_2d(z, theta["R"], self.eps))
        Kt_cross = fns.build_kt(theta, t=t_data, tprime=tstar)
        correction = kronlik.kron_cross_mean(Kphig, Kt_cross, V)
        return np.asarray(c_star + correction)

    def sample_prior(self, ntrials, type="csd", seed=1):
        """Prior CSD and/or (experimental) LFP draws; returns (csd, lfp) with
        NaNs for the branch not requested, matching ``gpcsd2d.py:336-360``."""
        fns = self._fns()
        theta = self._theta()
        nx, nt = self.x.shape[0], self.t.shape[0]
        Kt = fns.build_kt(theta)
        Lt = jnp.linalg.cholesky(Kt)
        key = jax.random.PRNGKey(seed)
        z = jax.random.normal(key, (ntrials, nx, nt), dtype=Lt.dtype)
        csd = np.nan * np.zeros((nx, nt, ntrials))
        lfp = np.nan * np.zeros((nx, nt, ntrials))
        if type in ("csd", "both"):
            Ks_csd = _se2d_kernel(self.x, self.x, theta["ell1"], theta["ell2"])
            Ls = jnp.linalg.cholesky(Ks_csd + JITTER * jnp.eye(nx))
            csd = np.moveaxis(np.asarray(jnp.einsum("xy,byt,st->bxs", Ls, z, Lt)), 0, 2)
        if type in ("lfp", "both"):
            Ks_lfp = self.spatial_cov.compKphi_2d(R=theta["R"], eps=self.eps)
            Ls = jnp.linalg.cholesky(jnp.asarray(Ks_lfp) + JITTER * jnp.eye(nx))
            lfp = np.moveaxis(np.asarray(jnp.einsum("xy,byt,st->bxs", Ls, z, Lt)), 0, 2)
        return csd, lfp
