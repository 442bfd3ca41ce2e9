"""Sharded-vs-local steps/s on the 8-fake-device CPU mesh (VERDICT r2 #7).

Measures the GSPMD sharding overhead of the identical phase runner: local
(1 device) vs mesh 8x1 (temp-sharded) and 4x2 (temp x chain) at a config-3
shape scaled to CPU (T=8, C=8, 8k bins)."""
import os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
_fl = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _fl:
    os.environ["XLA_FLAGS"] = (_fl + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
import jax
import numpy as np
from tamcmc_tpu.demos import make_demo
from tamcmc_tpu.sampler import init_state, make_beta_ladder
from tamcmc_tpu.sampler.driver import make_phase_runner
from tamcmc_tpu.parallel.mesh import make_sampler_mesh
from tamcmc_tpu.parallel.sharded import make_sharded_phase_runner, shard_state
from tamcmc_tpu.utils.cache import enable_compile_cache
enable_compile_cache()

T, C = 8, 8
problem, hp, plan, meta = make_demo("ms_global", seed=0, ngrid=8000)
betas = make_beta_ladder(T, hp.lambda_temp)
key = jax.random.PRNGKey(0)
key, sub = jax.random.split(key)
state0 = init_state(problem, hp, T, C, sub)

THIN, EMIT = 5, 20

def time_runner(runner, state, label, reps=3):
    k = jax.random.PRNGKey(1)
    k, s = jax.random.split(k)
    state, _ = runner(state, s)               # compile + settle
    jax.block_until_ready(state.theta)
    t0 = time.time()
    for _ in range(reps):
        k, s = jax.random.split(k)
        state, _ = runner(state, s)
    jax.block_until_ready(state.theta)
    dt = time.time() - t0
    sps = reps * THIN * EMIT / dt
    print(f"{label:18s} {sps:8.2f} steps/s  ({dt:.2f}s / {reps} chunks)")
    return sps

local = make_phase_runner(problem, hp, betas, adapt=True, thin=THIN, n_emit=EMIT)
sps_local = time_runner(local, state0, "local (1 dev)")

for tshard, cshard in ((8, 1), (4, 2), (2, 4)):
    mesh = make_sampler_mesh(tshard, cshard)
    runner = make_sharded_phase_runner(problem, hp, betas, mesh, True, THIN, EMIT)
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    st = shard_state(init_state(problem, hp, T, C, sub), mesh)
    sps = time_runner(runner, st, f"mesh {tshard}x{cshard}")
    print(f"  -> sharded/local ratio: {sps / sps_local:.3f}")

# Round-4 (VERDICT r3 #2b): explicit shard_map + ppermute fallback runner
# (parallel/shardmap_runner.py) A/B'd against GSPMD at the same shapes.
from tamcmc_tpu.parallel.shardmap_runner import make_shardmap_phase_runner

for tshard, cshard in ((8, 1), (4, 2), (2, 4)):
    mesh = make_sampler_mesh(tshard, cshard)
    runner = make_shardmap_phase_runner(problem, hp, betas, mesh, True,
                                        THIN, EMIT)
    key, sub = jax.random.split(jax.random.PRNGKey(0))
    st = shard_state(init_state(problem, hp, T, C, sub), mesh)
    sps = time_runner(runner, st, f"shardmap {tshard}x{cshard}")
    print(f"  -> shardmap/local ratio: {sps / sps_local:.3f}")
