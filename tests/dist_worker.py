"""Worker for the two-process localhost jax.distributed harness.

SURVEY.md section 4 (test ladder, item 4): "multi-host via jax.distributed
two-process localhost harness".  Launched by tests/test_distributed.py with
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID exported — the
same env contract `parallel.distributed.init_distributed` uses under any
real multi-host launcher.

Each process exposes 4 fake CPU devices; the 8-rung temperature ladder
therefore spans BOTH processes, so tempering-swap permutes cross the
process boundary (the inter-host analog) while walker reductions stay local.
"""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

import numpy as np
import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")

from tamcmc_tpu.parallel.distributed import (init_distributed,
                                             make_global_sampler_mesh,
                                             process_local_slice)


def main():
    assert init_distributed(), "env-driven jax.distributed bring-up failed"
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8, jax.devices()

    import jax.numpy as jnp
    from tamcmc_tpu.models import build_model
    from tamcmc_tpu.stats.priors import PriorTable
    from tamcmc_tpu.sampler.problem import Problem
    from tamcmc_tpu.sampler import init_state, make_beta_ladder, MALAHyper
    from tamcmc_tpu.parallel import shard_state, make_sharded_phase_runner

    fn, layout = build_model("model_Single_Lorentzian")
    nu = jnp.linspace(10.0, 90.0, 512)
    truth = jnp.asarray([12.0, 50.0, 2.0, 1.0])
    spec = fn(truth, nu) * jax.random.exponential(jax.random.PRNGKey(0), (512,))
    priors = PriorTable.from_rows([
        ("H", "jeffreys", 0.5, 100.0), ("nu0", "uniform", 30.0, 70.0),
        ("width", "jeffreys", 0.2, 20.0), ("white", "jeffreys", 0.05, 10.0)])
    problem = Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                      spec=spec, params0=jnp.asarray([8.0, 48.0, 3.0, 1.5]))
    hp = MALAHyper(use_drift=True, dN_mixing=1)

    T, C = 8, 4
    mesh = make_global_sampler_mesh(n_temp_shards=T, n_chain_shards=1)
    owners = {d.process_index for d in mesh.devices.flat}
    assert owners == {0, 1}, f"mesh does not span both processes: {owners}"

    betas = make_beta_ladder(T, 1.4)
    state = shard_state(init_state(problem, hp, T, C, jax.random.PRNGKey(1)),
                        mesh)
    runner = make_sharded_phase_runner(problem, hp, betas, mesh, adapt=True,
                                       thin=2, n_emit=2)
    state, outs = runner(state, jax.random.PRNGKey(2))
    jax.block_until_ready(state.theta)

    # theta0 is emitted fully replicated -> readable on every process.
    theta0 = np.asarray(outs["theta0"])
    assert np.all(np.isfinite(theta0)), "non-finite cold-chain samples"

    # Swap counters are sharded P('temp'); each process checks its local
    # rungs.  With dN_mixing=1 and 4 scan steps every pair must have been
    # attempted, including the pair straddling the process boundary.
    att_local = np.concatenate(
        [np.asarray(s.data) for s in state.nswap_att.addressable_shards])
    lo, hi = process_local_slice(T)
    assert hi - lo == T // 2
    pairs_local = att_local[:-1] if hi == T else att_local
    assert np.all(pairs_local > 0), f"unattempted swap pairs: {att_local}"

    print(f"DIST_OK pid={jax.process_index()} attempts={att_local.tolist()}",
          flush=True)

    # ---- stage 1b: explicit shard_map runner across the process boundary
    # (parallel/shardmap_runner.py): hand-placed ppermute neighbour
    # exchanges must work over gloo between REAL processes, not just the
    # single-process fake mesh the fast suite uses.
    from tamcmc_tpu.parallel.shardmap_runner import make_shardmap_phase_runner
    state2 = shard_state(init_state(problem, hp, T, C, jax.random.PRNGKey(1)),
                         mesh)
    smap = make_shardmap_phase_runner(problem, hp, betas, mesh, adapt=True,
                                      thin=2, n_emit=2)
    state2, outs2 = smap(state2, jax.random.PRNGKey(2))
    jax.block_until_ready(state2.theta)
    theta0b = np.asarray(outs2["theta0"])   # replicated over temp shards
    assert np.all(np.isfinite(theta0b)), "shardmap: non-finite cold samples"
    att2 = np.concatenate(
        [np.asarray(s.data) for s in state2.nswap_att.addressable_shards])
    pairs2 = att2[:-1] if hi == T else att2
    assert np.all(pairs2 > 0), f"shardmap unattempted swap pairs: {att2}"
    print(f"DIST_SHARDMAP_OK pid={jax.process_index()}", flush=True)

    # ---- stage 2: FULL user-facing B/L/A fit through the CLI ----
    # (VERDICT round-1 item 1: "the two-process gloo harness runs a full
    # B/L/A fit, not just swap bookkeeping").  Same entry point a user runs:
    # `tamcmc run --distributed --mesh 8x1`; each host writes its own sample
    # shard, process 0 owns metrics/summary/checkpoints.
    import tempfile
    from tamcmc_tpu.cli import main as cli_main

    outdir = os.environ.get("DIST_FIT_OUTDIR") or tempfile.mkdtemp(
        prefix="dist_fit_")
    cli_main(["run", "--demo", "single_lorentzian", "--outdir", outdir,
              "--distributed", "--mesh", "8x1", "--temps", "8",
              "--burnin", "60", "--learning", "120", "--acquire", "120",
              "--thin", "6", "--ckpt-every", "1", "--no-report"])
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("fit_done")

    pid = jax.process_index()
    import pathlib as _pl
    shard = _pl.Path(outdir) / f"A_samples.host{pid}.bin"
    assert shard.exists(), f"missing per-host shard {shard}"
    if pid == 0:
        from tamcmc_tpu.io.outputs import read_bin_samples
        samples, names = read_bin_samples(outdir, "A")
        assert samples.shape == (20 * 8, 4), samples.shape  # emits x walkers
        assert np.all(np.isfinite(samples))
        assert (_pl.Path(outdir) / "summary.json").exists()
        assert (_pl.Path(outdir) / "restore.npz").exists()
    print(f"DIST_FIT_OK pid={pid} outdir={outdir}", flush=True)


if __name__ == "__main__":
    main()
