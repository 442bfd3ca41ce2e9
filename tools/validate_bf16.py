"""Posterior validation of the bf16 Lorentzian stream (A/B lever a).

Round-2 VERDICT item 2 prescribed: bf16 grid arithmetic is only claimable
with "posterior moments validated vs f32 on configs 1-3".  This driver
runs the same fit twice in subprocesses (the flag is read at import) and
judges the pair with the parity harness — the same ESS-aware z-statistic
that defines reference parity.  Config 2 (Harvey background) has no
Lorentzians and is unaffected by construction.

Usage: python tools/validate_bf16.py   -> one JSON line per config + verdict.
"""
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

FIT_SNIPPET = """
import sys, numpy as np
sys.path.insert(0, {root!r})
from tamcmc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import jax
from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phases
from tamcmc_tpu.sampler.driver import PhasePlan
problem, hp, _plan, meta = make_demo({demo!r}, seed=0, **{demo_kw!r})
plan = PhasePlan(burnin=300, learning=1200, acquire=2400, thin=4, chunk=300)
T, C = 4, 8
betas = make_beta_ladder(T, hp.lambda_temp)
key = jax.random.PRNGKey(5)
key, sub = jax.random.split(key)
state = init_state(problem, hp, T, C, sub)
state, results = run_phases(problem, hp, betas, state, key, plan)
np.savez({out!r}, theta=results["A"]["theta0"],
         names=np.asarray(problem.free_names))
"""


def run_fit(demo, demo_kw, bf16, out):
    env = dict(os.environ)
    env["TAMCMC_LORENTZ_BF16"] = "1" if bf16 else ""
    code = FIT_SNIPPET.format(root=str(ROOT), demo=demo, demo_kw=demo_kw,
                              out=str(out))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=1200, stderr=subprocess.DEVNULL)


def main():
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from tamcmc_tpu.diagnostics.compare import compare_posteriors

    configs = [
        ("single_lorentzian", {}),                       # BASELINE config 1
        ("harvey_background", {}),                       # config 2 (control)
        ("ms_global", {"ngrid": 6000, "n_orders": 4}),   # config 3 CI scale
    ]
    all_ok = True
    with tempfile.TemporaryDirectory() as td:
        for demo, kw in configs:
            a, b = f"{td}/{demo}_f32.npz", f"{td}/{demo}_bf16.npz"
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
            print(json.dumps({"config": demo, "n_params": len(res["params"]),
                              "inconsistent": bad, "ok": ok}), flush=True)
    print(json.dumps({"verdict": "bf16 posterior-consistent with f32"
                      if all_ok else "bf16 FAILS posterior validation"}))
    sys.exit(0 if all_ok else 1)


if __name__ == "__main__":
    main()
