"""Windowed-flagship golden posterior anchor (round-4 VERDICT weak #6).

The config-1 golden (tests/golden/config1_posterior.json) anchors the bare
sampler; the FLAGSHIP path — static c*Gamma windows, disjoint-segment
accumulation, piece-wise chi22p with per-piece background, the bf16
profile-stream switch — is where almost every perf change lands, and a
silent stationary-distribution shift there is the largest class of
breakage a statistical regression can catch.  This tool:

  generate   long-run fits of the CI-scaled windowed flagship (demo
             ms_global, ngrid=6000, n_orders=4 — the same problem the
             precision validators use) under BOTH f32 and bf16, writing
             moments + ESS + provenance to tests/golden/flagship_posterior
             .json.  Each precision runs in a subprocess (the profile
             precision is latched at first trace).
  check      one moderate-length fit at a given precision (a subprocess,
             on the default device unless a platform is named) judged
             against the golden by an ESS-aware z-test — shared by the slow
             regression test (tests/test_parity_harness.py
             ::TestGoldenFlagship, on the CPU) and `chip_smoke.py` (on the
             GPU).

The anchor mirrors TestGoldenConfig1's ESS-aware z-test: a sampler or
kernel change that shifts the flagship's stationary distribution fails
before it can shift science results.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "flagship_posterior.json"

DEMO_KW = {"ngrid": 6000, "n_orders": 4}
T, C = 4, 16
# the moderate-length fit that is judged against the golden
CHECK_PLAN = dict(burnin=300, learning=1000, acquire=3000, thin=4, chunk=250)
CHECK_SEED = 7
# |z| of each parameter's mean difference must stay below Z_MAX, and its
# std ratio inside an ESS-aware band; with ~26 parameters tested, MAX_BAD
# marginal failures are allowed for multiple testing
Z_MAX, MAX_BAD = 4.0, 1

FIT_SNIPPET = """
import sys, numpy as np
sys.path.insert(0, {root!r})
from tamcmc_tpu.utils.backend import request_gpu_unless_told
from tamcmc_tpu.utils.cache import enable_compile_cache
request_gpu_unless_told()
enable_compile_cache()
import jax
if {precision!r} == "bf16":
    from tamcmc_tpu.ops.lorentzian import set_profile_precision
    set_profile_precision("bf16")
from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phases
from tamcmc_tpu.sampler.driver import PhasePlan
from tamcmc_tpu.diagnostics.ess import effective_sample_size
problem, hp, _plan, meta = make_demo("ms_global", seed=0, **{demo_kw!r})
assert problem._pieces_hook is not None, "piece-wise path must be engaged"
plan = PhasePlan(**{plan_kw!r})
betas = make_beta_ladder({T}, hp.lambda_temp)
key = jax.random.PRNGKey({seed})
key, sub = jax.random.split(key)
state = init_state(problem, hp, {T}, {C}, sub)
state, results = run_phases(problem, hp, betas, state, key, plan)
th = results["A"]["theta0"]
ess = np.asarray([effective_sample_size(th[:, :, i])
                  for i in range(th.shape[-1])])
np.savez({out!r}, theta=th, ess=ess,
         names=np.asarray(problem.free_names),
         truth=np.asarray(meta["truth"])[np.asarray(problem.priors.free_mask)],
         platform=jax.default_backend())
"""


def run_fit(precision, plan_kw, seed, out, platform=None):
    """One fit in a subprocess (the profile precision latches at first
    trace).  platform: JAX_PLATFORMS for the child (e.g. "cpu"); None
    keeps the default device."""
    env = dict(os.environ)
    if platform:
        env["JAX_PLATFORMS"] = platform
    code = FIT_SNIPPET.format(root=str(ROOT), precision=precision,
                              demo_kw=DEMO_KW, plan_kw=plan_kw, T=T, C=C,
                              seed=seed, out=str(out))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=3600)


def compare_to_golden(fit_npz, precision, golden=GOLDEN):
    """ESS-aware comparison of a fit's posterior with the golden moments.

    Per parameter: z = |mean - golden mean| / sqrt(s^2/ESS + s_g^2/ESS_g),
    and the std ratio inside exp(+-4 combined sigmas of log s), since
    Var[s]/s^2 ~ 1/(2 ESS) per side (floored at +-30%: a fixed 1.6x band
    false-failed on parameters with ESS ~10).  Moments in float64: f32
    accumulation over ~10^5 rows biases means by posterior sigmas.
    Returns one dict per golden parameter, with "ok"."""
    g = json.load(open(golden))[precision]
    z = np.load(fit_npz, allow_pickle=True)
    th = z["theta"].astype(np.float64)
    names = [str(n) for n in z["names"]]
    flat = th.reshape(-1, th.shape[-1])
    rows = []
    for i, name in enumerate(g["names"]):
        j = names.index(name)
        ess = max(float(z["ess"][j]), 2.0)
        std = flat[:, j].std(ddof=1)
        se = np.sqrt(std ** 2 / ess + g["std"][i] ** 2 / g["ess"][i])
        zstat = abs(flat[:, j].mean() - g["mean"][i]) / max(se, 1e-300)
        ratio = std / max(g["std"][i], 1e-300)
        band = max(np.exp(4.0 * np.sqrt(1 / (2 * ess)
                                        + 1 / (2 * g["ess"][i]))), 1.3)
        rows.append({"name": name, "z": round(float(zstat), 2),
                     "std_ratio": round(float(ratio), 3),
                     "band": round(float(band), 3),
                     "ok": bool(zstat < Z_MAX and 1 / band < ratio < band)})
    return rows


def check(precision, out, platform=None):
    """Run the moderate-length fit and judge it against the golden.
    Returns (passed, failing rows, platform the fit ran on)."""
    run_fit(precision, CHECK_PLAN, seed=CHECK_SEED, out=out,
            platform=platform)
    bad = [r for r in compare_to_golden(out, precision) if not r["ok"]]
    ran_on = str(np.load(out)["platform"])
    return len(bad) <= MAX_BAD, bad, ran_on


def generate():
    plan_kw = dict(burnin=500, learning=3000, acquire=24000, thin=4,
                   chunk=500)
    doc = {"provenance": {
        "demo": "ms_global", "demo_kw": DEMO_KW, "temps": T, "chains": C,
        "seed": 0, "plan": plan_kw, "date": "2026-08-21",
        "note": ("windowed-flagship long-run self-truth anchor (piece-wise "
                 "chi22p over the disjoint segment partition, per-piece "
                 "background); regenerate with tools/golden_flagship.py "
                 "generate if the sampler's STATISTICAL behaviour "
                 "legitimately changes")}}
    for precision in ("f32", "bf16"):
        print(f"generating {precision} golden (long run)...", flush=True)
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, f"golden_flagship_{precision}.npz")
            run_fit(precision, plan_kw, seed=0, out=out)
            z = dict(np.load(out, allow_pickle=True))
        # f64 BEFORE the axis-0 reductions: f32 accumulation over the
        # 96000-row flat array biased frequency means by ~1.7 uHz (2
        # posterior sigma) and inflated stds 2.2x in this golden's first
        # generation — the bug behind the round-5 f64-cast fixes across
        # diagnostics/ (means measured 2301.93-f32 vs 2300.26-f64)
        th = z["theta"].astype(np.float64).reshape(-1, z["theta"].shape[-1])
        doc[precision] = {
            "names": [str(n) for n in z["names"]],
            "mean": th.mean(axis=0).tolist(),
            "std": th.std(axis=0, ddof=1).tolist(),
            "ess": z["ess"].tolist(),
            "truth": z["truth"].tolist(),
        }
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "generate":
        generate()
    else:
        print(__doc__)
