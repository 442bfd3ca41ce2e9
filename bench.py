#!/usr/bin/env python
"""Headline benchmark: effective samples / s / chip on the multi-mode
peak-bagging fit (BASELINE.json config 3 scale).

Runs on an NVIDIA GPU only: it exits non-zero when JAX finds none.  Prints
ONE JSON line:
  {"metric": "eff_samples_per_s_per_chip", "value": N, "unit": "ESS/s",
   "vs_baseline": R, "device": {...}, "card": "<name>, <power limit>"}

vs_baseline is measured against the sequential NumPy architectural emulation
of the C++ reference (tamcmc_tpu/refimpl.py) run on the host — the real
cpptamcmc is not buildable here.  Statistical efficiency (ESS/step/walker)
is taken from the GPU run and shared with the baseline, so the ratio is
hardware+architecture throughput times walker-parallelism.
"""

import json
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tamcmc_tpu.utils.backend import (card_name_and_power_limit, device_info,
                                      require_gpu)
from tamcmc_tpu.utils.cache import enable_compile_cache


def main():
    require_gpu()
    enable_compile_cache()

    def log(m):
        print(f"# {m}", file=sys.stderr, flush=True)
    from tamcmc_tpu.demos import make_demo
    from tamcmc_tpu.sampler import init_state, make_beta_ladder
    from tamcmc_tpu.sampler.driver import make_phase_runner
    from tamcmc_tpu.diagnostics.ess import effective_sample_size

    # bf16 profile stream by default (posterior-validated vs f32 on
    # configs 1-3 — tools/validate_bf16.py); TAMCMC_BENCH_PRECISION=f32
    # for A/Bs.
    precision = os.environ.get("TAMCMC_BENCH_PRECISION", "bf16")
    from tamcmc_tpu.ops.lorentzian import set_profile_precision
    set_profile_precision(precision)

    log("building demo problem")
    problem, hp, plan, meta = make_demo("ms_global", seed=0)
    # walkers per rung: TAMCMC_BENCH_WALKERS (not yet swept on the GPU)
    T, C = meta["n_temps"], int(os.environ.get("TAMCMC_BENCH_WALKERS", "128"))
    betas = make_beta_ladder(T, hp.lambda_temp)
    key = jax.random.PRNGKey(0)
    key, sub = jax.random.split(key)
    state = init_state(problem, hp, T, C, sub)

    # --- adapt (not timed): burn-in + learning ---
    log("demo built; compiling warm runner")
    warm = make_phase_runner(problem, hp, betas, adapt=True, thin=5, n_emit=100)
    t0 = time.time()
    for _ in range(4):                      # 2000 adaptation steps
        key, sub = jax.random.split(key)
        state, _ = warm(state, sub)
    jax.block_until_ready(state.theta)
    t_warm = time.time() - t0
    log(f"warmup done in {t_warm:.1f}s")

    # --- timed acquire phase ---
    thin, n_emit, reps = 5, 200, 3
    acq = make_phase_runner(problem, hp, betas, adapt=False, thin=thin,
                            n_emit=n_emit)
    key, sub = jax.random.split(key)
    log("compiling acquire runner")
    state, _ = acq(state, sub)              # compile + settle (not timed)
    jax.block_until_ready(state.theta)
    t1 = time.time()
    chunks = []
    for _ in range(reps):
        key, sub = jax.random.split(key)
        state, outs = acq(state, sub)
        chunks.append(outs["theta0"])
    jax.block_until_ready(state.theta)
    dt = time.time() - t1
    log(f"timed acquire done in {dt:.1f}s")
    theta = np.concatenate([np.asarray(c) for c in chunks], axis=0)  # (E,C,Df)

    n_steps = reps * n_emit * thin
    steps_per_s = n_steps / dt

    # --- mesh-1x1 sharding ratios: zero-communication overhead of the GSPMD
    # annotations and the explicit shard_map runner vs the local runner,
    # same shapes/work.
    # TAMCMC_BENCH_SHARDING=0 skips (saves 2 compiles for quick A/Bs).
    shard_ratios = {}
    if os.environ.get("TAMCMC_BENCH_SHARDING", "1") != "0":
        from tamcmc_tpu.parallel.mesh import make_sampler_mesh
        from tamcmc_tpu.parallel.sharded import (make_sharded_phase_runner,
                                                 shard_state)
        from tamcmc_tpu.parallel.shardmap_runner import \
            make_shardmap_phase_runner
        mesh1 = make_sampler_mesh(1, 1)
        for kind, make in (("gspmd", make_sharded_phase_runner),
                           ("shardmap", make_shardmap_phase_runner)):
            log(f"measuring mesh-1x1 {kind} ratio")
            runner = make(problem, hp, betas, mesh1, False, thin, n_emit)
            # deep-copy first: device_put onto the same single device is a
            # no-copy alias, and the runner's donation would delete the
            # shared buffer out from under `state`
            st = shard_state(jax.tree.map(lambda x: jnp.array(x, copy=True),
                                          state), mesh1)
            key, sub = jax.random.split(key)
            st, _ = runner(st, sub)             # compile + settle
            jax.block_until_ready(st.theta)
            best = None
            for _ in range(2):
                key, sub = jax.random.split(key)
                ts = time.time()
                st, _ = runner(st, sub)
                jax.block_until_ready(st.theta)
                best = min(best or 1e9, time.time() - ts)
            shard_ratios[kind] = round((n_emit * thin / best) / steps_per_s, 3)
            log(f"mesh-1x1 {kind}: ratio {shard_ratios[kind]}")

    # ESS summed over free params' slowest? Headline: mean ESS across params
    E, Cc, Df = theta.shape
    ess = np.array([effective_sample_size(theta[:, :, i]) for i in range(Df)])
    ess_med = float(np.median(ess))
    ess_per_s = ess_med / dt
    ess_per_step_per_walker = ess_med / (E * thin) / Cc  # thinned emits * thin raw steps

    # --- baseline: sequential numpy emulation of the C++ architecture ---
    from tamcmc_tpu.refimpl import SequentialSampler
    spec_np = np.asarray(problem.spec, dtype=np.float64)
    nu_np = np.asarray(problem.nu, dtype=np.float64)
    model_fn = jax.jit(problem.model_fn)

    free_idx = problem.free_idx
    p0 = np.asarray(problem.params0, dtype=np.float64)

    # pure-numpy model+likelihood (no jax) for the baseline
    def np_loglike(x):
        full = p0.copy()
        full[free_idx] = x
        m = _np_model(full, nu_np)
        m = np.maximum(m, 1e-12)
        return -np.sum(np.log(m) + spec_np / m)

    layout = problem.layout
    import tamcmc_tpu.ops.rotation as rot

    def _np_model(p, nu):
        """numpy mirror of model_MS_Global_a1etaa3_HarveyLike WITH the
        reference's algorithmic advantages (VERDICT round-1 weak item 2 /
        next item 6): each Lorentzian is evaluated only inside its
        truncation window c*Gamma (optimum_lorentzian_calc_* [U] —
        ~10-15%% of the grid per mode), and the per-(l,n,m) component loop
        body is one vectorised slice op, as Eigen vectorises the C++ inner
        loop.  This is the STRONG baseline: emulating the C++'s algorithm,
        not just its serial architecture."""
        def blk(name):
            o = layout.offset(name)
            return p[o:o + layout.size(name)]
        heights, widths = blk("heights"), blk("widths")
        vis = blk("visibilities")
        f0 = blk("freq_l0")
        inc = blk("inclination")[0]
        a1, sw, a3, asym = blk("rot")
        trunc = float(blk("trunc")[0]) if "trunc" in layout.names else 40.0
        total = np.zeros_like(nu)
        ci, si = np.cos(inc), np.sin(inc)
        eps_l = {0: np.array([1.0]),
                 1: np.array([0.5 * si**2, ci**2, 0.5 * si**2]),
                 2: np.array([3 / 8 * si**4, 1.5 * ci**2 * si**2,
                              0.25 * (3 * ci**2 - 1) ** 2,
                              1.5 * ci**2 * si**2, 3 / 8 * si**4])}
        for l in (0, 1, 2):
            fl = blk(f"freq_l{l}")
            if fl.size == 0:
                continue
            h = heights if l == 0 else np.interp(fl, f0, heights) * vis[l - 1]
            w = widths if l == 0 else np.interp(fl, f0, widths)
            m_arr = np.arange(-l, l + 1)
            p3 = (np.asarray(rot.rl_polynomials(l, 3)[2]) if l >= 2
                  else np.zeros(2 * l + 1))
            for i in range(fl.size):
                wi = max(w[i], 1e-6)
                nus = fl[i] + m_arr * a1 + a3 * p3
                half = trunc * wi                   # c*Gamma window [U]
                for j, eps in enumerate(eps_l[l]):
                    lo = np.searchsorted(nu, nus[j] - half)
                    hi = np.searchsorted(nu, nus[j] + half)
                    x = 2.0 * (nu[lo:hi] - nus[j]) / wi
                    total[lo:hi] += h[i] * eps / (1.0 + x * x)
        noise = blk("noise")
        for k in range(3):
            A, B, pw = noise[3 * k:3 * k + 3]
            if A > 0 and B > 0:
                total += A / (1 + (B * nu) ** pw)
        return total + max(noise[9], 0.0)

    def np_logprior(x):
        return 0.0  # flat inside support; adequate for throughput timing

    scales = np.asarray(
        __import__("tamcmc_tpu.sampler.mala", fromlist=["default_init_scales"]
                   ).default_init_scales(problem))
    x0 = p0[free_idx]
    seq = SequentialSampler(np_loglike, np_logprior, x0, scales,
                            n_temps=T, lambda_temp=hp.lambda_temp, seed=0)
    n_ref = 30
    t2 = time.time()
    for _ in range(n_ref):
        seq.step()
    ref_dt = time.time() - t2
    ref_steps_per_s = n_ref / ref_dt
    ref_ess_per_s = ess_per_step_per_walker * ref_steps_per_s  # 1 walker/rung

    result = {
        "metric": "eff_samples_per_s_per_chip",
        "value": round(ess_per_s, 2),
        "unit": "ESS/s",
        "vs_baseline": round(ess_per_s / max(ref_ess_per_s, 1e-12), 1),
        # headline-level so cross-round comparisons can't miss a precision
        # switch (round-4 advisor, low)
        "precision": precision,
        "device": device_info(),
        "card": card_name_and_power_limit(),
        "detail": {
            "precision": precision,
            "raw_steps_per_s": round(steps_per_s, 1),
            "walkers": int(Cc), "temps": int(T),
            "grid_bins": int(np.asarray(problem.nu).shape[0]),
            "free_dims": int(Df),
            "ess_median_per_param": round(ess_med, 1),
            "baseline_steps_per_s_numpy_sequential": round(ref_steps_per_s, 2),
            "warmup_s": round(t_warm, 1),
            "timed_s": round(dt, 1),
            "t_full_step_ms": round(dt / n_steps * 1e3, 3),
            # mesh-1x1 sharded/local steps-per-s ratios (~1.0 = the
            # zero-communication annotation overhead is nil)
            **({f"mesh1x1_{k}_ratio": v for k, v in shard_ratios.items()}),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
