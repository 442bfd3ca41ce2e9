"""Two-process localhost jax.distributed harness (SURVEY.md section 4,
test-ladder item 4): the FULL sharded sampler step — MALA + tempering-swap
permutes + adaptation reductions — runs over a mesh spanning two OS
processes, with gloo CPU collectives standing in for the inter-host network.

The workers live in tests/dist_worker.py; this launcher exercises the same
env-var contract (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID) that `parallel.distributed.init_distributed` expects under
any real multi-host launcher.
"""
import os
import pathlib
import socket
import subprocess
import sys

import pytest

WORKER = pathlib.Path(__file__).with_name("dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_sampler(tmp_path):
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs, logs = [], []
    for pid in range(2):
        env = dict(env_base,
                   JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
                   DIST_FIT_OUTDIR=str(tmp_path / "dist_fit"))
        log = open(tmp_path / f"worker{pid}.log", "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)], env=env,
            stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=480)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out = log.read()
        log.close()
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"DIST_OK pid={pid}" in out, out[-4000:]
        assert f"DIST_SHARDMAP_OK pid={pid}" in out, out[-4000:]
        assert f"DIST_FIT_OK pid={pid}" in out, out[-4000:]
