"""Multi-PROCESS sharding overhead: the cross-process ratio (round-4 VERDICT #1).

The fake-mesh tables (tools/scale_cpu.py) measure sharded-vs-local inside ONE
process; the two-process gloo harness (tests/test_distributed.py) proves
cross-process *correctness*.  The missing scaling number — the last one this
single-chip sandbox can produce — is the THROUGHPUT cost of the process
boundary itself: the same total work, on the same 8-device mesh with the
same layouts, run once inside a single OS process and once spanning two
processes with gloo collectives standing in for the inter-host network.

    ratio = steps/s(2 processes, 4 fake devices each)
          / steps/s(1 process, 8 fake devices)

Both denominators timeshare the same physical cores (8 device threads on
this host either way), so the ratio isolates the cross-process collective
path — serialization, gloo transport, coordination — not raw compute.  This
is overhead-SHAPE evidence for the >=80 % multi-host north star (SURVEY
section 6); proving the target itself still needs real multi-host
hardware.

Layouts: 8x1 (temp fully sharded — every tempering swap crosses the process
boundary), 2x4 (walker-heavy — adaptation pmeans cross it every step).
Runners: gspmd (annotation) and shardmap (explicit collectives).

Usage: python tools/scale_procs.py           -> ratio table + JSON lines
       (internal) --worker is the measured subprocess body.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

T, C = 8, 8
THIN, EMIT, REPS = 5, 20, 3
# SCALE_LAYOUTS / SCALE_RUNNERS trim the matrix (the slow-suite guard
# runs one combo to stay inside its budget)
LAYOUTS = tuple(tuple(int(v) for v in x.split("x")) for x in
                os.environ.get("SCALE_LAYOUTS", "8x1,2x4").split(","))
RUNNERS = tuple(os.environ.get("SCALE_RUNNERS", "gspmd,shardmap").split(","))


# --------------------------------------------------------------------------
# worker body: measure every (layout, runner) combo; process 0 prints JSON
# --------------------------------------------------------------------------
def worker():
    n_local_dev = int(os.environ["SCALE_LOCAL_DEVS"])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{n_local_dev}").strip()
    sys.path.insert(0, str(ROOT))
    from tamcmc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from tamcmc_tpu.parallel.distributed import (init_distributed,
                                                 make_global_sampler_mesh)
    multi = init_distributed()
    import numpy as np
    from jax.experimental import multihost_utils
    from tamcmc_tpu.demos import make_demo
    from tamcmc_tpu.sampler import init_state, make_beta_ladder
    from tamcmc_tpu.parallel.sharded import (make_sharded_phase_runner,
                                             shard_state)
    from tamcmc_tpu.parallel.shardmap_runner import make_shardmap_phase_runner

    problem, hp, _plan, _meta = make_demo("ms_global", seed=0, ngrid=8000)
    betas = make_beta_ladder(T, hp.lambda_temp)
    pid = jax.process_index()

    def sync():
        if multi:
            multihost_utils.sync_global_devices("timer")

    for tsh, csh in LAYOUTS:
        mesh = make_global_sampler_mesh(tsh, csh)
        for kind in RUNNERS:
            make = (make_sharded_phase_runner if kind == "gspmd"
                    else make_shardmap_phase_runner)
            runner = make(problem, hp, betas, mesh, True, THIN, EMIT)
            key = jax.random.PRNGKey(1)
            st = shard_state(init_state(problem, hp, T, C,
                                        jax.random.PRNGKey(0)), mesh)
            key, s = jax.random.split(key)
            st, _ = runner(st, s)                     # compile + settle
            jax.block_until_ready(st.theta)
            sync()
            t0 = time.time()
            for _ in range(REPS):
                key, s = jax.random.split(key)
                st, _ = runner(st, s)
            jax.block_until_ready(st.theta)
            sync()
            dt = time.time() - t0
            if pid == 0:
                print(json.dumps({
                    "layout": f"{tsh}x{csh}", "runner": kind,
                    "nprocs": jax.process_count(),
                    "steps_per_s": round(REPS * THIN * EMIT / dt, 2)}),
                    flush=True)
    if multi:
        multihost_utils.sync_global_devices("done")


# --------------------------------------------------------------------------
# launcher: 1-process (8 devs) vs 2-process (4 devs each), ratio per combo
# --------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(nprocs):
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    if nprocs == 1:
        env = dict(env_base, SCALE_LOCAL_DEVS="8")
        out = subprocess.run([sys.executable, __file__, "--worker"],
                             env=env, capture_output=True, text=True,
                             timeout=2400)
        assert out.returncode == 0, out.stderr[-3000:]
        text = out.stdout
    else:
        port = _free_port()
        procs, logs = [], []
        for pid in range(nprocs):
            env = dict(env_base, SCALE_LOCAL_DEVS=str(8 // nprocs),
                       JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                       JAX_NUM_PROCESSES=str(nprocs),
                       JAX_PROCESS_ID=str(pid))
            logs.append(open(f"/tmp/scale_procs_{pid}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker"], env=env,
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=2400)
        text = ""
        for pid, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            body = log.read()
            log.close()
            assert p.returncode == 0, f"proc {pid}:\n{body[-3000:]}"
            if pid == 0:
                text = body
    rows = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{"):
            r = json.loads(line)
            rows[(r["layout"], r["runner"])] = r["steps_per_s"]
    return rows


def main():
    if "--worker" in sys.argv:
        return worker()
    print(f"work: ms_global 8k bins, T={T} C={C}, {REPS * THIN * EMIT} raw "
          f"steps per timing, layouts {LAYOUTS}, runners {RUNNERS}")
    single = launch(1)
    double = launch(2)
    print(f"{'layout':8s} {'runner':9s} {'1-proc':>9s} {'2-proc':>9s} "
          f"{'ratio':>7s}")
    for (tsh, csh) in LAYOUTS:
        for kind in RUNNERS:
            k = (f"{tsh}x{csh}", kind)
            s1, s2 = single.get(k), double.get(k)
            ratio = s2 / s1 if s1 and s2 else float("nan")
            print(f"{k[0]:8s} {kind:9s} {s1:9.2f} {s2:9.2f} {ratio:7.3f}")
            print(json.dumps({"layout": k[0], "runner": kind,
                              "steps_per_s_1proc": s1,
                              "steps_per_s_2proc": s2,
                              "ratio_2proc_over_1proc": round(ratio, 3)}))


if __name__ == "__main__":
    main()
