"""The parity harness exercised on the model class that matters.

Round-3 VERDICT next #4: `tamcmc compare`/compare_posteriors is the tool
that will one day judge reference parity (BASELINE.json metric: "posterior
moments match within Monte-Carlo error"), but until now it was only tested
on analytic/iid/own-export cases.  Here it judges:

  * cross-seed consistency of TWO independent full B/L/A flagship fits
    (CI-scaled config 3) — the harness's intended workload, end to end;
  * a long-run GOLDEN posterior summary for config 1 checked into
    tests/golden/ — a statistical regression anchor: any change that
    shifts the sampler's stationary distribution fails this before it
    could silently shift science results.
"""
import json
import pathlib
import sys

import numpy as np
import pytest
import jax

from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phases
from tamcmc_tpu.sampler.driver import PhasePlan
from tamcmc_tpu.diagnostics.compare import compare_posteriors

GOLDEN = pathlib.Path(__file__).parent / "golden" / "config1_posterior.json"
sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "tools"))


def _fit(demo, seed, plan, T, C, **demo_kw):
    problem, hp, _plan, meta = make_demo(demo, seed=0, **demo_kw)
    betas = make_beta_ladder(T, hp.lambda_temp)
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    state = init_state(problem, hp, T, C, sub)
    state, results = run_phases(problem, hp, betas, state, key, plan)
    return problem, results["A"]["theta0"]        # (E, C, Df)


@pytest.mark.slow
class TestCrossSeedFlagship:
    def test_two_seeds_consistent(self):
        """Two independent sampler seeds of the SAME CI-scaled config-3
        problem must be judged consistent by the parity harness (identical
        data/problem; only the PRNG stream differs — the definition of
        parity SURVEY hard-part 6 prescribes)."""
        plan = PhasePlan(burnin=300, learning=1000, acquire=1500, thin=4,
                         chunk=125)
        problem, th_a = _fit("ms_global", 11, plan, 4, 6,
                             ngrid=3000, n_orders=3)
        _, th_b = _fit("ms_global", 12, plan, 4, 6,
                       ngrid=3000, n_orders=3)
        names = problem.free_names
        res = compare_posteriors(th_a, names, th_b, names,
                                 z_threshold=4.0)
        bad = [r for r in res["params"] if not r["ok"]]
        # allow 1 marginal parameter out of ~30 at z~4 (multiple testing),
        # but the overall set must be overwhelmingly consistent
        assert len(bad) <= 1, bad


@pytest.mark.slow
class TestGoldenConfig1:
    def test_golden_anchor_matches(self):
        """A fresh moderate-length config-1 fit must match the checked-in
        long-run golden moments within ESS-aware MC error.  Fails if a
        sampler change shifts the stationary distribution."""
        g = json.load(open(GOLDEN))
        plan = PhasePlan(burnin=500, learning=2000, acquire=4000, thin=4,
                         chunk=500)
        problem, th = _fit("single_lorentzian", 99, plan, 3, 8)
        # golden side: reconstruct (N, D) pseudo-samples is unnecessary —
        # compare via the harness's z-statistic using stored moments
        flat = th.reshape(-1, th.shape[-1])
        from tamcmc_tpu.diagnostics.ess import effective_sample_size
        for i, name in enumerate(g["names"]):
            j = problem.free_names.index(name)
            ess = max(effective_sample_size(th[:, :, j]), 2.0)
            se = np.sqrt(flat[:, j].std(ddof=1) ** 2 / ess
                         + g["std"][i] ** 2 / g["ess"][i])
            z = abs(flat[:, j].mean() - g["mean"][i]) / max(se, 1e-300)
            assert z < 4.0, (name, z, flat[:, j].mean(), g["mean"][i])
            ratio = flat[:, j].std(ddof=1) / max(g["std"][i], 1e-300)
            assert 1 / 1.5 < ratio < 1.5, (name, ratio)

    def test_golden_provenance_recorded(self):
        g = json.load(open(GOLDEN))
        assert g["provenance"]["demo"] == "single_lorentzian"
        assert set(g) >= {"names", "mean", "std", "ess", "truth"}


GOLDEN_FLAGSHIP = pathlib.Path(__file__).parent / "golden" / \
    "flagship_posterior.json"


@pytest.mark.slow
class TestGoldenFlagship:
    """Windowed-flagship stationary-distribution anchor (round-4 VERDICT
    weak #6): the piece-wise chi22p + segment partition + bf16 switch all
    live on this path; a kernel/sampler change that shifts its posterior
    must fail CI.  Fits run in subprocesses (the profile precision latches
    at first trace and must not leak into the shared test session)."""

    @pytest.mark.parametrize("precision", ["f32", "bf16"])
    def test_flagship_matches_golden(self, precision, tmp_path):
        from golden_flagship import check

        passed, bad, ran_on = check(precision,
                                    str(tmp_path / f"fit_{precision}.npz"),
                                    platform="cpu")
        assert ran_on == "cpu"
        assert passed, bad


class TestGoldenCheck:
    """The golden_flagship z-test itself (shared by the slow test and the
    chip smoke), on synthetic posteriors drawn from the golden moments."""

    def _fit(self, tmp_path, shift_sigmas=0.0):
        g = json.load(open(GOLDEN_FLAGSHIP))["f32"]
        rng = np.random.default_rng(3)
        E, C = 2000, 4
        mean, std = np.asarray(g["mean"]), np.asarray(g["std"])
        th = mean + std * rng.standard_normal((E, C, mean.size))
        th += shift_sigmas * std
        out = tmp_path / "fit.npz"
        np.savez(out, theta=th, ess=np.full(mean.size, float(E * C)),
                 names=np.asarray(g["names"]), truth=np.asarray(g["truth"]),
                 platform="cpu")
        return out

    def test_fit_from_the_golden_moments_passes(self, tmp_path):
        from golden_flagship import MAX_BAD, compare_to_golden
        rows = compare_to_golden(self._fit(tmp_path), "f32")
        assert sum(not r["ok"] for r in rows) <= MAX_BAD, rows

    def test_shifted_fit_fails(self, tmp_path):
        from golden_flagship import MAX_BAD, compare_to_golden
        rows = compare_to_golden(self._fit(tmp_path, shift_sigmas=1.0),
                                 "f32")
        assert sum(not r["ok"] for r in rows) > MAX_BAD
