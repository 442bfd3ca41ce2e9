"""Sharded execution of the sampler over a (temp, chain) device mesh.

Strategy: the single-chip step (sampler/mala.py, sampler/tempering.py) is
already written as batched array programs over leading (T, C) axes with
static-partner gathers for swaps and walker-mean reductions for adaptation.
Scaling out is therefore a *sharding annotation*, not a rewrite: we jit the
identical step with NamedShardings pinned on inputs and outputs and let XLA
GSPMD lower

  * the tempering-swap gather  x[partner]  on the 'temp' axis to a
    collective-permute between neighbouring rungs,
  * the walker means/einsums on the 'chain' axis to psum reductions,

exactly the plan of SURVEY.md section 5.8.  Multi-host extension: call
`jax.distributed.initialize()` before building the mesh — the same code
lowers collectives within a host (NVLink) and across hosts.

(An explicit shard_map + ppermute implementation is the planned perf
fallback if GSPMD's choices prove suboptimal; profile first.)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tamcmc_tpu.parallel.mesh import state_shardings
from tamcmc_tpu.sampler.driver import _raw_step


def shard_state(state, mesh):
    """Place a host-built SamplerState onto the mesh with the standard layout."""
    sh = state_shardings(mesh)
    return jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh)


def make_sharded_phase_runner(problem, hp, betas, mesh, adapt: bool,
                              thin: int, n_emit: int):
    """Sharded analog of sampler.driver.make_phase_runner.

    Returns jitted (state, key) -> (state, outputs) with state pinned to the
    mesh layout; outputs are emitted with the cold rung fully replicated
    (small host-bound records).
    """
    sh = state_shardings(mesh)
    rep = NamedSharding(mesh, P())

    from tamcmc_tpu.sampler.driver import make_record

    def run(data, state, key):
        raw = _raw_step(problem.with_data(data), hp, betas, adapt)

        def super_step(state, key):
            keys = jax.random.split(key, thin)
            state, _ = jax.lax.scan(raw, state, keys)
            return state, make_record(state)

        keys = jax.random.split(key, n_emit)
        return jax.lax.scan(super_step, state, keys)

    # ALL records are emitted fully replicated: they are small (the cold
    # rung + per-rung scalars), and replication means every host can
    # device_get them directly — the multi-host writer path needs no
    # collectives of its own.  (logL (E,T,C) costs one tiny all-gather per
    # emit, amortised over `thin` raw steps.)
    out_record_sh = {
        "theta0": rep, "logL": rep, "logP": rep,
        "logP0": rep, "log_sigma": rep, "acc_rate": rep, "mu0": rep,
        "cov_diag0": rep, "swap_att": rep, "swap_acc": rep,
    }
    # the problem's data arrays are replicated arguments (Problem.data)
    jitted = jax.jit(run,
                     in_shardings=(rep, sh, rep),
                     out_shardings=(sh, out_record_sh),
                     donate_argnums=(1,))
    # host copies: a multi-process mesh takes replicated host values where
    # a process-local device array would not be a global array
    data = {k: np.asarray(v) for k, v in problem.data().items()}
    return lambda state, key: jitted(data, state, key)


def gather_state_to_host(state):
    """Full host copy of a (possibly multi-host-sharded) SamplerState.

    Single-host meshes: a plain device_get.  Multi-host: non-addressable
    arrays are all-gathered across processes first, so every host can write
    a complete restore checkpoint (SURVEY.md section 5.4 — restore files
    must be self-contained)."""
    def g(x):
        if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
            from jax.experimental import multihost_utils
            return np.asarray(multihost_utils.process_allgather(x, tiled=True))
        return np.asarray(x)
    return jax.tree.map(g, state)
