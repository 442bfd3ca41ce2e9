"""f64 validation anchor: f32 contract vs double-precision sampling.

The reference samples in f64 (SURVEY.md section 0 — C++/Eigen doubles
throughout [U]); this rebuild's contract is f32 with a
documented u-space standardization making that safe (docs/PARITY.md
documents the config-4 f32 adaptation collapse that motivated it).  The
round-4 VERDICT (missing #3) asked for the missing anchor: fit BASELINE
configs 1-3 twice — f32 vs f64 (CPU enable_x64, the `--precision f64`
path) — with the same seed protocol as tools/validate_bf16.py, judged by
the parity harness's ESS-aware z-scores.  Consistency anchors the whole
f32/u-space design against subtle precision bias; any inconsistency must
be investigated, not thresholded away.

Both sides run on CPU so the ONLY difference is arithmetic precision
(the f32 side is statistically the accelerator contract; PRNG streams
are identical bit-generators either way).

Usage: python tools/validate_f64.py   -> one JSON line per config + verdict.
Record of results: docs/PARITY.md "f64 validation anchor".
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

FIT_SNIPPET = """
import os, sys, numpy as np
sys.path.insert(0, {root!r})
from tamcmc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import jax
f64 = os.environ.get("TAMCMC_VALIDATE_F64") == "1"
import jax.numpy as jnp
from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phases
from tamcmc_tpu.sampler.driver import PhasePlan
# Build the problem BEFORE enabling x64: the demo's synthetic data
# generation must draw the IDENTICAL f32 realization on both sides —
# enabling x64 first changes the uniform/exponential streams and the two
# fits then target different data (first run of this tool: z_max 102,
# every param "inconsistent" — a data mismatch, not precision bias).
problem, hp, _plan, meta = make_demo({demo!r}, seed=0, **{demo_kw!r})
if f64:
    jax.config.update("jax_enable_x64", True)
    problem = problem.astype(jnp.float64)
plan = PhasePlan(burnin=300, learning=1200, acquire=2400, thin=4, chunk=300)
T, C = 4, 8
betas = make_beta_ladder(T, hp.lambda_temp)
key = jax.random.PRNGKey(5)
key, sub = jax.random.split(key)
state = init_state(problem, hp, T, C, sub)
assert state.theta.dtype == (jnp.float64 if f64 else jnp.float32), \
    state.theta.dtype
state, results = run_phases(problem, hp, betas, state, key, plan)
np.savez({out!r}, theta=results["A"]["theta0"],
         names=np.asarray(problem.free_names))
"""


def run_fit(demo, demo_kw, f64, out):
    env = dict(os.environ)
    env["TAMCMC_VALIDATE_F64"] = "1" if f64 else ""
    env["JAX_PLATFORMS"] = "cpu"
    code = FIT_SNIPPET.format(root=str(ROOT), demo=demo, demo_kw=demo_kw,
                              out=str(out))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=1800, stderr=subprocess.DEVNULL)


def main():
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from tamcmc_tpu.diagnostics.compare import compare_posteriors

    configs = [
        ("single_lorentzian", {}),                       # BASELINE config 1
        ("harvey_background", {}),                       # config 2
        ("ms_global", {"ngrid": 6000, "n_orders": 4}),   # config 3 CI scale
    ]
    all_ok = True
    with tempfile.TemporaryDirectory() as td:
        for demo, kw in configs:
            a, b = f"{td}/{demo}_f32.npz", f"{td}/{demo}_f64.npz"
            run_fit(demo, kw, False, a)
            run_fit(demo, kw, True, b)
            za, zb = np.load(a, allow_pickle=True), \
                np.load(b, allow_pickle=True)
            res = compare_posteriors(za["theta"], [str(n) for n in za["names"]],
                                     zb["theta"], [str(n) for n in zb["names"]],
                                     z_threshold=4.0)
            bad = [r["name"] for r in res["params"] if not r["ok"]]
            ok = len(bad) <= max(1, len(res["params"]) // 20)
            all_ok &= ok
            zmax = max(abs(r["z"]) for r in res["params"])
            print(json.dumps({"config": demo, "n_params": len(res["params"]),
                              "z_max": round(zmax, 2),
                              "inconsistent": bad, "ok": ok}), flush=True)
    print(json.dumps({"verdict": "f32 posterior-consistent with f64"
                      if all_ok else "f32 FAILS f64 validation — investigate, "
                      "do not threshold away"}))
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
