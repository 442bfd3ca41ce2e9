"""In-scan A/B of hot-kernel levers at the bench config (VERDICT r3 #1).

Times the REAL acquire-phase runner (scan of full MALA steps: a kernel
timed alone in its own jit is not the context it runs in) under a variant
selected by env:

  baseline                       round-3 hot path
  TAMCMC_VJP_STORE_INV=1         store inv from fwd in the custom VJP
  TAMCMC_LORENTZ_BF16=1          bf16 profile arithmetic, f32 accumulation

Prints one JSON line {variant, ms_per_step, steps_per_s} with the device it
ran on; record every result in PERF.md whether it wins or loses.  Run each
variant in a FRESH process (the flags are read at import).
"""
import json
import os
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
from tamcmc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import jax
import numpy as np


def main():
    from tamcmc_tpu.demos import make_demo
    from tamcmc_tpu.sampler import init_state, make_beta_ladder
    from tamcmc_tpu.sampler.driver import make_phase_runner

    variant = "baseline"
    if os.environ.get("TAMCMC_VJP_STORE_INV") == "1":
        variant = "store_inv"
    if os.environ.get("TAMCMC_LORENTZ_BF16") == "1":
        variant = "bf16_grid"

    problem, hp, plan, meta = make_demo("ms_global", seed=0)
    T = meta["n_temps"]
    C = int(os.environ.get("TAMCMC_BENCH_WALKERS", "128"))
    betas = make_beta_ladder(T, hp.lambda_temp)
    state = init_state(problem, hp, T, C, jax.random.PRNGKey(0))

    THIN, EMIT, REPS = 5, 100, 4
    acq = make_phase_runner(problem, hp, betas, adapt=False,
                            thin=THIN, n_emit=EMIT)
    key = jax.random.PRNGKey(1)
    key, sub = jax.random.split(key)
    state, outs = acq(state, sub)           # compile + settle
    jax.block_until_ready(state.theta)
    best = None
    for _ in range(REPS):
        key, sub = jax.random.split(key)
        t0 = time.time()
        state, outs = acq(state, sub)
        jax.block_until_ready(state.theta)
        d = time.time() - t0
        best = d if best is None else min(best, d)
    dt = best
    n_steps = THIN * EMIT
    th = np.asarray(outs["theta0"])
    print(json.dumps({
        "variant": variant,
        "walkers": C,
        "ms_per_step": round(dt / n_steps * 1e3, 3),
        "steps_per_s": round(n_steps / dt, 1),
        "finite": bool(np.all(np.isfinite(th))),
        "theta_mean_probe": round(float(th.mean()), 6),
    }))


if __name__ == "__main__":
    main()
