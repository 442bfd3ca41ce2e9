"""chip_smoke.py off the card: its CPU reference children and comparison
helpers at a tiny width, and its refusal to run anywhere but on a GPU."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TINY = [{"demo": "kepler_full", "demo_kw": {"ngrid": 1500, "n_orders": 2},
         "TC": [2, 4]},
        {"demo": "subgiant_mixed", "demo_kw": {"ngrid": 1500, "n_orders": 2},
         "TC": [2, 4]}]


def _env(**kw):
    env = dict(os.environ)
    env.update(kw)
    return env


@pytest.fixture(scope="module")
def cpu_refs(tmp_path_factory):
    """The parity phase's CPU children (f64, f32, bf16) at a tiny width."""
    d = tmp_path_factory.mktemp("refs")
    procs = {}
    for prec in ("f64", "f32", "bf16"):
        spec = {"precision": prec, "configs": TINY,
                "out": str(d / f"ref_{prec}.npz")}
        procs[prec] = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--child",
             "parity-cpu", json.dumps(spec)], cwd=ROOT,
            env=_env(JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for prec, p in procs.items():
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, (prec, out[-3000:])
    return {prec: np.load(d / f"ref_{prec}.npz") for prec in procs}


def _parts(z, i):
    return {"logL": z[f"{i}_logL"], "gradL": z[f"{i}_gradL"]}


class TestParityHelpers:
    @pytest.mark.parametrize("precision", ["f32", "bf16"])
    def test_windowed_config4_within_floors_of_f64(self, cpu_refs,
                                                   precision):
        """On config 4's windowed path the CPU at f32/bf16 meets the
        tolerance floors against float64: the floors are not tighter than
        what a correct backend achieves there."""
        err = chip_smoke.parity_errors(_parts(cpu_refs[precision], 0),
                                       _parts(cpu_refs["f64"], 0))
        no_slack = chip_smoke.parity_tolerance(
            {"max_rel_dlogL": 0.0, "max_rel_grad": 0.0}, precision)
        assert chip_smoke.within(err, no_slack), err

    @pytest.mark.parametrize("precision", ["f32", "bf16"])
    def test_tolerance_is_twice_the_cpu_error(self, cpu_refs, precision):
        """Where f32 itself is far from f64 (config 5's ARMM root solve),
        the tolerance follows the CPU's own error, not the floor."""
        err = chip_smoke.parity_errors(_parts(cpu_refs[precision], 1),
                                       _parts(cpu_refs["f64"], 1))
        tol = chip_smoke.parity_tolerance(err, precision)
        floor_logl, floor_grad = chip_smoke.FLOORS[precision]
        assert tol["rel_logL"] == max(2 * err["max_rel_dlogL"], floor_logl)
        assert tol["rel_grad"] == max(2 * err["max_rel_grad"], floor_grad)
        assert chip_smoke.within(err, tol)

    def test_perturbed_gradient_is_refused(self, cpu_refs):
        ref = _parts(cpu_refs["f64"], 0)
        cpu_err = chip_smoke.parity_errors(_parts(cpu_refs["f32"], 0), ref)
        bad = dict(ref, gradL=ref["gradL"] * (1 + 1e-2))
        err = chip_smoke.parity_errors(bad, ref)
        assert not chip_smoke.within(
            err, chip_smoke.parity_tolerance(cpu_err, "f32"))

    def test_nonfinite_is_refused(self, cpu_refs):
        ref = _parts(cpu_refs["f64"], 1)
        bad = dict(ref, logL=np.where(np.arange(ref["logL"].size).reshape(
            ref["logL"].shape) == 0, np.nan, ref["logL"]))
        err = chip_smoke.parity_errors(bad, ref)
        assert not chip_smoke.within(err, {"rel_logL": 1.0, "rel_grad": 1.0})


class TestProposalPrecision:
    def test_pinned_proposal_matches_float64(self):
        from tamcmc_tpu.sampler import MALAHyper
        from tamcmc_tpu.sampler.analytic import std_gaussian
        pe = chip_smoke.proposal_errors(std_gaussian(24),
                                        MALAHyper(use_drift=True), 2, 8)
        assert pe["accepted"] > 0
        assert pe["pinned_step"] <= chip_smoke.PROPOSAL_TOL, pe
        assert pe["pinned"] <= chip_smoke.PROPOSAL_TOL, pe


class TestFourCardComparison:
    def test_first_records_agree_flags_a_flipped_walker(self):
        rng = np.random.default_rng(0)
        theta = 2000.0 + rng.normal(size=(8, 5))
        logl = -1e5 + rng.normal(size=8)
        same = chip_smoke.first_records_agree(theta, logl,
                                              theta * (1 + 1e-8), logl)
        assert same.all()
        moved = theta.copy()
        moved[3, 1] += 0.05                  # one rejected/accepted flip
        agree = chip_smoke.first_records_agree(moved, logl, theta, logl)
        assert agree.sum() == 7 and not agree[3]


class TestGpuTestsVerdict:
    @pytest.mark.parametrize("summary, passed", [
        ("3 passed in 12.31s", True),
        ("3 passed, 590 deselected in 9.10s", True),
        ("2 passed, 1 skipped in 3.02s", False),
        ("3 skipped in 1.00s", False),
        ("1 failed, 2 passed in 4.20s", False),
        ("2 passed, 1 error in 4.20s", False),
        ("no tests ran in 0.50s", False),
    ])
    def test_only_passes_count(self, summary, passed):
        """A skipped gpu test means the card was not seen: not a pass."""
        assert chip_smoke.pytest_all_passed(summary) is passed


class TestRefusesWithoutGpu:
    def test_device_child_refuses_cpu(self):
        p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--child", "device", "{}"], cwd=ROOT,
                           env=_env(JAX_PLATFORMS="cpu"), capture_output=True,
                           text=True, timeout=300)
        assert p.returncode != 0
        assert "DEVICE" not in p.stdout

    def test_script_fails_without_a_card(self):
        p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                           cwd=ROOT, env=_env(JAX_PLATFORMS="cpu"),
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"ok": true' not in p.stdout

    def test_script_alone_fails(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"ok": true' not in p.stdout
