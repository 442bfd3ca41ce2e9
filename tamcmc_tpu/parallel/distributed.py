"""Multi-host scale-out: jax.distributed bring-up + global sampler meshes.

SURVEY.md section 5.8: the reference has NO distributed backend (one C++
process, serial chain loop).  The rebuild's story is JAX collectives over a
mesh whose axes span hosts: the fast intra-host links (NVLink) within a
host, the network across hosts.  This
module is the thin, testable bring-up layer:

  * `init_distributed(...)` — idempotent wrapper around
    `jax.distributed.initialize`, env-var driven so the same entry point
    works under any launcher that exports coordinator/process-count/pid
    (GKE, slurm, or the localhost two-process harness in
    tests/test_distributed.py).
  * `make_global_sampler_mesh(...)` — builds the (temp, chain) mesh from
    jax.devices() (ALL processes' devices), keeping each temperature rung's
    walkers on one host where possible so adaptation reductions stay inside
    a host and only the (rare, dN_mixing-amortised) tempering swaps cross
    the network.

Everything downstream (parallel/sharded.py) is process-count agnostic:
jit + NamedSharding handle multi-host global arrays natively.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh

_INITIALIZED = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> bool:
    """Initialise the JAX distributed runtime (idempotent).

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers only need to export
    those.  Returns True if a multi-process runtime is active after the
    call, False for single-process runs (no env, no args).
    """
    global _INITIALIZED
    if _INITIALIZED:
        return jax.process_count() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or num_processes is None or process_id is None:
        return False        # single-process mode
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _INITIALIZED = True
    return jax.process_count() > 1


def make_global_sampler_mesh(n_temp_shards: int,
                             n_chain_shards: int = 1) -> Mesh:
    """(temp, chain) mesh over ALL processes' devices.

    Device order: jax.devices() groups by process; we lay temperatures over
    the slowest-varying (cross-host) dimension so each rung's walker shards
    are host-local — adaptation psums stay inside a host, only temp-axis
    swap permutes cross the network (and only every dN_mixing steps).
    """
    devices = jax.devices()
    need = n_temp_shards * n_chain_shards
    if len(devices) < need:
        raise ValueError(
            f"mesh ({n_temp_shards}x{n_chain_shards}) needs {need} devices; "
            f"{jax.process_count()} process(es) expose {len(devices)}")
    dev = np.asarray(devices[:need]).reshape(n_temp_shards, n_chain_shards)
    return Mesh(dev, ("temp", "chain"))


def process_local_slice(arr_len: int):
    """(start, stop) of this process's shard of a length-arr_len leading
    axis split evenly over processes — for host-side IO of globally sharded
    outputs (each host writes its own rows)."""
    n, pid = jax.process_count(), jax.process_index()
    per = arr_len // n
    extra = arr_len % n
    start = pid * per + min(pid, extra)
    stop = start + per + (1 if pid < extra else 0)
    return start, stop
