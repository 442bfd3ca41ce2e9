"""Tests that need an NVIDIA GPU.  They skip elsewhere; on the card run

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

(`python chip_smoke.py` does)."""
import json
import pathlib
import sys

import numpy as np
import pytest
import jax

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.gpu


def test_demo_data_and_scan_carry_stay_on_the_gpu(gpu):
    """Demo data are generated on the host CPU; neither they nor the scan
    carry may stay committed there (that would pull the sampler onto the
    host)."""
    from tamcmc_tpu.demos import make_demo
    from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phase
    problem, hp, _, _ = make_demo("ms_global", seed=0, ngrid=2000,
                                  n_orders=2)
    assert problem.spec.devices() == {gpu}
    assert problem.nu.devices() == {gpu}
    state = init_state(problem, hp, 2, 4, jax.random.PRNGKey(0))
    betas = make_beta_ladder(2, hp.lambda_temp)
    state, outs = run_phase(problem, hp, betas, state, jax.random.PRNGKey(1),
                            20, adapt=True, thin=5, chunk=4)
    assert state.theta.devices() == {gpu}
    assert np.isfinite(outs["theta0"]).all()


def test_proposal_products_pinned_on_the_card(gpu):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import PROPOSAL_TOL, proposal_errors
    from tamcmc_tpu.sampler import MALAHyper
    from tamcmc_tpu.sampler.analytic import std_gaussian
    pe = proposal_errors(std_gaussian(91), MALAHyper(use_drift=True), 2, 16)
    assert pe["accepted"] > 0
    assert pe["pinned_step"] <= PROPOSAL_TOL, pe
    assert pe["pinned"] <= PROPOSAL_TOL, pe


def test_cli_run_records_the_gpu(gpu, tmp_path):
    from tamcmc_tpu.cli import main
    main(["run", "--demo", "single_lorentzian", "--outdir", str(tmp_path),
          "--burnin", "40", "--learning", "40", "--acquire", "40",
          "--thin", "4", "--temps", "2", "--chains", "4", "--no-report"])
    events = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    start = next(e for e in events if e["event"] == "run_start")
    assert start["backend"] == "gpu"
    assert start["device_kind"] == gpu.device_kind
    ends = [e for e in events if e["event"] == "phase_end"]
    assert [e["carry_platforms"] for e in ends] == [["gpu"]] * 3
