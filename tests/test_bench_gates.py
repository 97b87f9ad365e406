"""bench.py sampler-health gates: a NUTS rate must be impossible to report
from a degenerate, frozen, divergent or non-mixing run."""

import importlib.util
import os

import numpy as np

spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py")
)
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)


def test_nuts_fit_starts_at_generating_temporal_parameters(monkeypatch):
    for name, value in (("NX", 4), ("NT", 12), ("NTRIALS", 2), ("NGL", 20)):
        monkeypatch.setattr(bench, name, value)
    m = bench.build_nuts_problem(0, het_noise="exact")
    theta = m._theta()
    seen = {}

    def fake_fit(n_restarts, seed, options):
        seen.update(n_restarts=n_restarts, seed=seed, **options)

    monkeypatch.setattr(m, "fit", fake_fit)
    bench.fit_nuts_problem(m, seed=3, n_restarts=5)
    start = seen.pop("init_overrides")
    assert seen == dict(n_restarts=5, seed=3)
    assert sorted(start) == sorted(bench.NUTS_FIT_START)
    for k, v in start.items():
        np.testing.assert_array_equal(v, np.asarray(theta[k]))


def _healthy():
    return dict(steps=22.0, accept=0.8, n_divergent=0, max_rhat=1.01,
                max_depth=7)


def _failures(**over):
    return bench.nuts_gate_failures(**{**_healthy(), **over})


class TestArtifactGates:
    def test_healthy_passes(self):
        assert _failures() == []
        # the trajectory cap follows max_depth: 2**(max_depth-1) leapfrogs
        assert _failures(steps=64.0) == []
        assert _failures(steps=64.0, max_depth=6) != []

    def test_round2_frozen_chains_rejected(self):
        fails = _failures(max_rhat=1.2e4)  # chains stuck in separate places
        assert any("R-hat" in f for f in fails)
        # every tree at the depth cap with collapsed acceptance: frozen
        assert _failures(steps=127.0, accept=0.05) != []

    def test_round3_degenerate_leapfrogs_rejected(self):
        fails = _failures(steps=1.0)  # ~1 leapfrog per transition
        assert len(fails) == 1 and "leapfrogs" in fails[0]

    def test_missing_fields_rejected(self):
        fails = bench.nuts_gate_failures(None, None, None, None, 7)
        assert len(fails) == 4
        assert _failures(max_rhat=None) != []

    def test_borderline_rhat(self):
        assert _failures(max_rhat=1.99) == []
        assert _failures(max_rhat=2.0) != []
        assert _failures(accept=0.6) == [] and _failures(accept=0.95) == []
        assert _failures(accept=0.59) != [] and _failures(accept=0.96) != []
        assert _failures(n_divergent=1) != []
