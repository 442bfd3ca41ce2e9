"""A/B: adaptive temperature ladder vs static geometric (VERDICT r4 #8).

Same problem, same seed, same B/L/A plan — once with the fixed geometric
ladder, once with --adapt-ladder semantics (Vousden tuning during
Learning, frozen in Acquire).  Judged on the north star's own axis:
effective samples per second of the TIMED Acquire phase, plus the pair
swap-acceptance spread the tuner is supposed to flatten.

Configs: 4 (kepler_full, many rungs — where ladder shape matters most)
and 5 (subgiant_mixed).  Grid/order counts are scaled by env for CI vs
chip runs:
    TAMCMC_AB_NGRID / TAMCMC_AB_ORDERS / TAMCMC_AB_PLAN=b,l,a,thin

Usage: python tools/ab_ladder.py  -> one JSON line per (config, arm).
Record results in PERF.md, with the device they ran on.
"""
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from tamcmc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

import numpy as np
import jax

from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder
from tamcmc_tpu.sampler.driver import run_phase
from tamcmc_tpu.diagnostics.ess import effective_sample_size


def fit(demo, demo_kw, plan, T, C, adaptive):
    import dataclasses
    problem, hp, _plan, _meta = make_demo(demo, seed=0, **demo_kw)
    hp = dataclasses.replace(hp, adapt_ladder=adaptive)
    betas = make_beta_ladder(T, hp.lambda_temp)
    ladder = None
    if adaptive:
        ladder = {"betas": np.asarray(betas, dtype=np.float64), "updates": 0,
                  "last_att": np.zeros(T), "last_acc": np.zeros(T)}
    key = jax.random.PRNGKey(3)
    key, sub = jax.random.split(key)
    state = init_state(problem, hp, T, C, sub)
    b, l, a, thin = plan
    for steps, adapt in ((b, True), (l, True)):
        key, sub = jax.random.split(key)
        state, _ = run_phase(problem, hp, betas, state, sub, steps,
                             adapt=adapt, thin=thin, chunk=100,
                             ladder=ladder)
    # warm the acquire runner OUTSIDE the timed region (one chunk): the
    # static and adaptive arms compile different programs (betas constant
    # vs traced argument) and a compile inside the timing would swamp the
    # per-step difference
    key, sub = jax.random.split(key)
    state, _ = run_phase(problem, hp, betas, state, sub, 100 * thin,
                         adapt=False, thin=thin, chunk=100, ladder=ladder)
    att0 = np.asarray(state.nswap_att).copy()
    acc0 = np.asarray(state.nswap_acc).copy()
    key, sub = jax.random.split(key)
    t0 = time.time()
    state, outs = run_phase(problem, hp, betas, state, sub, a,
                            adapt=False, thin=thin, chunk=100, ladder=ladder)
    jax.block_until_ready(state.theta)
    dt = time.time() - t0
    th = outs["theta0"]
    ess = np.asarray([effective_sample_size(th[:, :, i])
                      for i in range(th.shape[-1])])
    att = np.asarray(state.nswap_att) - att0
    acc = np.asarray(state.nswap_acc) - acc0
    rates = (acc[:-1] / np.maximum(att[:-1], 1)).round(3)
    return {"ess_per_s": round(float(np.median(ess)) / dt, 1),
            "ess_median": round(float(np.median(ess)), 1),
            "acquire_s": round(dt, 1),
            "swap_rates": rates.tolist(),
            "swap_spread": round(float(rates.std()), 4),
            "final_betas": (None if ladder is None else
                            [round(float(x), 5) for x in ladder["betas"]])}


def main():
    ngrid = int(os.environ.get("TAMCMC_AB_NGRID", "0")) or None
    orders = int(os.environ.get("TAMCMC_AB_ORDERS", "0")) or None
    plan = tuple(int(x) for x in os.environ.get(
        "TAMCMC_AB_PLAN", "1000,4000,6000,5").split(","))
    configs = [
        ("kepler_full", {"ngrid": ngrid, "n_orders": orders}, 10, 16),
        ("subgiant_mixed", {"ngrid": ngrid, "n_orders": orders}, 8, 16),
    ]
    for demo, kw, T, C in configs:
        kw = {k: v for k, v in kw.items() if v}
        for arm in ("static", "adaptive"):
            r = fit(demo, kw, plan, T, C, adaptive=arm == "adaptive")
            print(json.dumps({"config": demo, "T": T, "C": C, "arm": arm,
                              **r}), flush=True)


if __name__ == "__main__":
    main()
