#!/usr/bin/env python
"""Smoke test on the GPU: the tempered-MALA fit end to end on the card.

    python chip_smoke.py          one card (phases below)
    python chip_smoke.py --four   four cards: `tamcmc run --mesh 4x1` with
                                  both sharded runners, against one card

The parent process never starts JAX.  Every phase runs in a child process,
one after another, so one process at a time holds the card (a JAX process
reserves most of a card's memory when it first touches it).  The children
share the persistent compile cache (tamcmc_tpu/utils/cache.py) and the GPU
compile flags (tamcmc_tpu/utils/backend.py).  The float64 references of the
parity phase run on the host CPU, at low priority, beside the GPU phases:
those children never open the card.

One-card phases, sized to finish inside 20 minutes with compilation (each
full-width program takes 30-90 s to compile on an H100):
  device     platform, device kind and count as JAX reports them; the
             card's name and power limit as nvidia-smi reports them
  run        `tamcmc run` at full width on config 4 (kepler_full: 120,000
             bins, l <= 3, 14 orders, 10 rungs, 64 walkers per rung),
             killed in Acquire after a --ckpt-every checkpoint and resumed.
             Samples, .hdr, restore.npz and summary.json written and
             finite, the scan carry on the GPU; steps/s and wall time per
             phase, compile included
  parity     config 4's likelihood and gradient for a (10, 64) batch of
             walkers, f32 and bf16 on the card against float64 on the CPU;
             the proposal's matmul precision; what XLA makes of the
             config-4 Lorentzian forward+backward
  posterior  the flagship golden (tools/golden_flagship.py) re-run on the
             card in f32 and bf16, judged by its ESS-aware z-test
  gpu-tests  the `gpu`-marked pytest tests (tests/test_gpu.py)
  config5    `tamcmc run` at full width on config 5 (subgiant_mixed: 60,000
             bins, ARMM mixed modes on the dense Lorentzian path, 8 rungs,
             64 walkers per rung), checked like config 4

Any failed phase ends the script with a non-zero exit and no result line.
On success the last line of stdout is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import argparse
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import zipfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
GPU_PLATFORMS = "cuda,cpu"

# full-width configurations: BASELINE configs 4 and 5, demo defaults
CONFIG4 = {"demo": "kepler_full", "demo_kw": {}}
CONFIG5 = {"demo": "subgiant_mixed", "demo_kw": {}}
PARITY_TC = (10, 64)
WALKER_SEED = 2026
# `tamcmc run` phase lengths: 100 / 100 / ACQUIRE[config] steps
ACQUIRE = {4: 200, 5: 100}
THIN = 5


def run_flags(config):
    return ["--chains", "64", "--burnin", "100", "--learning", "100",
            "--acquire", str(ACQUIRE[config]), "--thin", str(THIN),
            "--chunk", "10", "--no-report", "--max-rows", "3"]

# Parity tolerance floors (relative |dlogL|, per-walker relative gradient
# L2 error).  The tolerance is twice what the CPU achieves at the same
# precision against the same float64 reference, never below these floors:
# the GPU sums in another order than the CPU (per-bin reductions over up to
# 120,000 bins, tree-shaped), so agreement is to f32 (or bf16) rounding,
# not bitwise.
FLOORS = {"f32": (1e-5, 1e-3), "bf16": (1e-3, 2e-2)}
# the proposal's per-walker relative error with its products pinned at
# HIGHEST (~1e-6 expected; TF32 would give ~1e-3)
PROPOSAL_TOL = 1e-5


class PhaseFailed(Exception):
    pass


# ---------------------------------------------------------------------------
# helpers shared by the parent, the children and the tests (numpy only)
# ---------------------------------------------------------------------------

def parity_errors(got: dict, ref: dict) -> dict:
    """Errors of (logL (T, C), gradL (T, C, Df)) against a reference."""
    logL, gradL = np.asarray(got["logL"]), np.asarray(got["gradL"])
    rlogL, rgrad = np.asarray(ref["logL"]), np.asarray(ref["gradL"])
    dl = np.abs(logL.astype(np.float64) - rlogL)
    gerr = (np.linalg.norm(gradL.astype(np.float64) - rgrad, axis=-1)
            / np.maximum(np.linalg.norm(rgrad, axis=-1), 1e-300))
    finite = bool(np.isfinite(logL).all() and np.isfinite(gradL).all())
    return {"finite": finite,
            "max_abs_dlogL": float(dl.max()),
            "max_rel_dlogL": float((dl / np.abs(rlogL)).max()),
            "max_rel_grad": float(gerr.max())}


def parity_tolerance(cpu_err: dict, precision: str) -> dict:
    floor_logl, floor_grad = FLOORS[precision]
    return {"rel_logL": max(2 * cpu_err["max_rel_dlogL"], floor_logl),
            "rel_grad": max(2 * cpu_err["max_rel_grad"], floor_grad)}


def within(err: dict, tol: dict) -> bool:
    return (err["finite"] and err["max_rel_dlogL"] <= tol["rel_logL"]
            and err["max_rel_grad"] <= tol["rel_grad"])


def first_records_agree(theta_a, logl_a, theta_b, logl_b,
                        rtol=1e-6, atol=1e-6):
    """Per walker: does the first emitted cold-rung record of run a agree
    with run b?  theta (C, Df) physical units, logL (C,).  Returns the
    boolean agreement per walker."""
    th = np.isclose(theta_a, theta_b, rtol=rtol, atol=atol).all(axis=-1)
    ll = np.isclose(logl_a, logl_b, rtol=rtol, atol=0.0)
    return th & ll


def read_samples(outdir, phase):
    """(emits, walkers, Df) samples of a phase, through the repo's reader
    (it checks the .bin against its .hdr)."""
    from tamcmc_tpu.io.outputs import read_bin_samples
    return read_bin_samples(outdir, phase, with_chains=True)[0]


def demo_flags(cfg):
    """`tamcmc run` flags selecting a config's demo at its width."""
    flags = ["--demo", cfg["demo"]]
    for k, v in cfg["demo_kw"].items():
        flags += ["--" + k.replace("_", "-"), str(v)]
    return flags


def metrics(outdir):
    return [json.loads(line) for line in open(pathlib.Path(outdir)
                                               / "metrics.jsonl")]


# ---------------------------------------------------------------------------
# child bodies (run as `python chip_smoke.py --child NAME SPEC_JSON`)
# ---------------------------------------------------------------------------

def draw_walkers(problem, T, C, seed=WALKER_SEED):
    """(T, C, Df) walkers around params0, one init scale apart, as f32
    values (every precision evaluates the identical points)."""
    from tamcmc_tpu.sampler.mala import default_init_scales
    x0 = np.asarray(problem.params0, np.float64)[problem.free_idx]
    scales = np.asarray(default_init_scales(problem), np.float64)
    z = np.random.default_rng(seed).standard_normal((T, C, x0.size))
    return (x0 + scales * z).astype(np.float32)


def _build_problems(configs, precision):
    """Demo problems for each config at `precision` ("f32", "bf16" or
    "f64").  All data are generated BEFORE x64 is enabled: enabling it
    first changes the synthetic draw stream."""
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.demos import make_demo
    if precision == "bf16":
        from tamcmc_tpu.ops.lorentzian import set_profile_precision
        set_profile_precision("bf16")
    problems = [make_demo(c["demo"], seed=0, **c["demo_kw"])[0]
                for c in configs]
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
        problems = [p.astype(jnp.float64) for p in problems]
    return problems


def jit_logparts_and_grad(problem):
    """batched_logparts_and_grad jitted with the problem's data arrays as
    arguments, as the sampler's runners take them: x -> parts."""
    import jax
    f = jax.jit(lambda data, x: problem.with_data(
        data).batched_logparts_and_grad(x))
    data = problem.data()
    return lambda x: f(data, x)


def evaluate_parts(f, theta, dtype, rungs_per_call=None):
    """logL and gradL from `f` = jit_logparts_and_grad(problem) at walkers
    theta (T, C, Df), in one call or `rungs_per_call` rungs at a time
    (bounds host memory)."""
    import jax.numpy as jnp
    step = rungs_per_call or theta.shape[0]
    logL, gradL = [], []
    for t in range(0, theta.shape[0], step):
        (l, _), (g, _) = f(jnp.asarray(theta[t:t + step], dtype))
        logL.append(np.asarray(l, np.float64))
        gradL.append(np.asarray(g, np.float64))
    return {"logL": np.concatenate(logL), "gradL": np.concatenate(gradL)}


def child_device(spec):
    from tamcmc_tpu.utils.backend import device_info, require_gpu
    require_gpu()
    print("DEVICE " + json.dumps(device_info()))


def child_parity_cpu(spec):
    """Reference values on the host CPU; never opens the card."""
    import jax
    from tamcmc_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if jax.default_backend() != "cpu":
        raise SystemExit(f"parity-cpu ran on {jax.default_backend()}")
    problems = _build_problems(spec["configs"], spec["precision"])
    out = {}
    for i, (cfg, problem) in enumerate(zip(spec["configs"], problems)):
        theta = draw_walkers(problem, *cfg["TC"])
        parts = evaluate_parts(jit_logparts_and_grad(problem), theta,
                               problem.params0.dtype, rungs_per_call=1)
        out[f"{i}_logL"], out[f"{i}_gradL"] = parts["logL"], parts["gradL"]
    np.savez(spec["out"], **out)


def proposal_errors(problem, hp, T, C, seed=WALKER_SEED):
    """Relative error of the MALA proposal `mean + sigma * L @ xi` against
    float64 NumPy, per walker (max over walkers):

      pinned_step  through mala_step itself (its einsums pinned at
                   HIGHEST), on walkers that accepted (u = 0);
      pinned / unpinned  the factor product L @ xi alone, with the pin and
                   with the backend's default f32 matmul precision.
    """
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.sampler import init_state, make_beta_ladder
    from tamcmc_tpu.sampler.mala import _matvec, mala_step
    Df = problem.ndim_free
    rng = np.random.default_rng(seed)
    L = (np.tril(rng.normal(0.0, 0.2, (T, C, Df, Df)), -1)
         + np.eye(Df)).astype(np.float32)
    L64 = L.astype(np.float64)
    cov64 = L64 @ np.swapaxes(L64, -1, -2)
    state = init_state(problem, hp, T, C, jax.random.PRNGKey(seed))
    state = state.replace(
        chol=jnp.asarray(L), cov=jnp.asarray(cov64, jnp.float32),
        ichol=jnp.asarray(np.linalg.inv(L64), jnp.float32),
        log_sigma=jnp.full((T, C), np.log(0.05), jnp.float32))
    xi = rng.standard_normal((T, C, Df)).astype(np.float32)
    betas = make_beta_ladder(T, hp.lambda_temp)
    step = jax.jit(lambda s, x, u: mala_step(problem, hp, betas, s, None,
                                             adapt=False, draws=(x, u)))
    new = step(state, jnp.asarray(xi), jnp.zeros((T, C), jnp.float32))

    th = np.asarray(state.theta, np.float64)
    b = np.asarray(betas, np.float64)[:, None, None]
    g = b * np.asarray(state.gradL, np.float64) + np.asarray(state.gradP,
                                                             np.float64)
    if hp.use_drift:
        norm = np.linalg.norm(g, axis=-1, keepdims=True)
        drift = g * np.minimum(1.0, hp.drift_delta / np.maximum(norm, 1e-30))
        mean = th + 0.5 * 0.05 ** 2 * np.einsum("tcij,tcj->tci", cov64, drift)
    else:
        mean = th
    Lxi = np.einsum("tcij,tcj->tci", L64, xi.astype(np.float64))
    ref = mean + 0.05 * Lxi
    prop = np.asarray(new.theta, np.float64)
    moved = np.any(prop != th, axis=-1)
    step_norm = np.linalg.norm(ref - th, axis=-1)

    def rel(a, b, norm):
        return np.linalg.norm(a - b, axis=-1) / norm

    pinned = np.asarray(jax.jit(_matvec)(L, xi), np.float64)
    unpinned = np.asarray(jax.jit(
        lambda a, v: jnp.einsum("tcij,tcj->tci", a, v))(L, xi), np.float64)
    lnorm = np.linalg.norm(Lxi, axis=-1)
    return {
        "accepted": int(moved.sum()), "walkers": T * C,
        "pinned_step": (float(rel(prop, ref, step_norm)[moved].max())
                        if moved.any() else float("nan")),
        "pinned": float(rel(pinned, Lxi, lnorm).max()),
        "unpinned": float(rel(unpinned, Lxi, lnorm).max()),
    }


def child_parity_gpu(spec):
    """Card values against the CPU references: likelihood, gradient, and
    (f32) the proposal precision and the Lorentzian fwd+bwd time."""
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.utils.backend import require_gpu
    from tamcmc_tpu.utils.cache import enable_compile_cache
    require_gpu()
    enable_compile_cache()
    precision, card = spec["precision"], spec["card"]
    problems = _build_problems(spec["configs"], precision)
    ref = np.load(spec["ref_f64"])
    cpu = np.load(spec["ref_cpu"])
    ok = True
    for i, (cfg, problem) in enumerate(zip(spec["configs"], problems)):
        theta = draw_walkers(problem, *cfg["TC"])
        if problem.spec.devices() != {jax.devices()[0]}:
            raise SystemExit(f"{cfg['demo']} data on "
                             f"{problem.spec.devices()}, not the GPU")
        f = jit_logparts_and_grad(problem)
        got = evaluate_parts(f, theta, jnp.float32)
        r = {"logL": ref[f"{i}_logL"], "gradL": ref[f"{i}_gradL"]}
        cpu_err = parity_errors({"logL": cpu[f"{i}_logL"],
                                 "gradL": cpu[f"{i}_gradL"]}, r)
        err = parity_errors(got, r)
        tol = parity_tolerance(cpu_err, precision)
        passed = within(err, tol)
        ok &= passed
        print(f"parity {cfg['demo']} {precision} (T, C) = {tuple(cfg['TC'])}"
              f" vs float64 CPU: GPU max|dlogL| {err['max_abs_dlogL']:.3e},"
              f" rel dlogL {err['max_rel_dlogL']:.3e} (tol "
              f"{tol['rel_logL']:.1e}), rel grad {err['max_rel_grad']:.3e}"
              f" (tol {tol['rel_grad']:.1e}); CPU {precision}: rel dlogL "
              f"{cpu_err['max_rel_dlogL']:.3e}, rel grad "
              f"{cpu_err['max_rel_grad']:.3e} -> "
              f"{'ok' if passed else 'FAIL'}  [{card}]")
        if i == 0:
            x = jnp.asarray(theta)
            jax.block_until_ready(f(x))                 # compile excluded
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                jax.block_until_ready(f(x))
                times.append(time.perf_counter() - t0)
            print(f"timing {cfg['demo']} {precision} Lorentzian fwd+bwd "
                  f"(batched_logparts_and_grad, (T, C) = {tuple(cfg['TC'])},"
                  f" XLA): median {1e3 * np.median(times):.3f} ms, min "
                  f"{1e3 * min(times):.3f} ms over 10 calls  [{card}]")
    if precision == "f32":
        # the proposal's products at config 4's width (Df) and batch, on a
        # Gaussian target: the einsum path is the same for every model
        from tamcmc_tpu.sampler import MALAHyper
        from tamcmc_tpu.sampler.analytic import std_gaussian
        cfg, Df = spec["configs"][0], problems[0].ndim_free
        pe = proposal_errors(std_gaussian(Df), MALAHyper(use_drift=True),
                             *cfg["TC"])
        passed = pe["pinned_step"] <= PROPOSAL_TOL and \
            pe["pinned"] <= PROPOSAL_TOL
        ok &= passed
        print(f"proposal (Df = {Df}, (T, C) = {tuple(cfg['TC'])}) vs float64"
              f" NumPy: mala_step (pinned HIGHEST) rel err "
              f"{pe['pinned_step']:.3e} on {pe['accepted']}/{pe['walkers']}"
              f" accepted walkers; L @ xi pinned {pe['pinned']:.3e}, "
              f"unpinned (backend default) {pe['unpinned']:.3e} (tol "
              f"{PROPOSAL_TOL:.0e}) -> {'ok' if passed else 'FAIL'}  [{card}]")
    if not ok:
        raise SystemExit("parity outside tolerance")


CHILDREN = {"device": child_device, "parity-cpu": child_parity_cpu,
            "parity-gpu": child_parity_gpu}


# ---------------------------------------------------------------------------
# parent: phases
# ---------------------------------------------------------------------------

def _env(platforms):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platforms
    return env


def _tail(path, n=40):
    lines = pathlib.Path(path).read_text(errors="replace").splitlines()
    return "\n".join(lines[-n:])


def run_child(name, spec, work, platforms=GPU_PLATFORMS, timeout=900,
              label=None):
    """Run a child body; returns its stdout.  Its stderr goes to a log."""
    log = work / f"{label or name}.log"
    with open(log, "w") as err:
        p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--child", name, json.dumps(spec)],
                           cwd=ROOT, env=_env(platforms), stdout=subprocess.PIPE,
                           stderr=err, text=True, timeout=timeout)
    if p.returncode != 0:
        raise PhaseFailed(f"child {name} exited {p.returncode}:\n{p.stdout}"
                          f"\n{_tail(log)}")
    return p.stdout


def start_child(name, spec, work, platforms, label):
    """A background child at low priority (it must not slow the GPU
    phases' compiles)."""
    with open(work / f"{label}.log", "w") as log:
        return subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--child", name, json.dumps(spec)],
                                cwd=ROOT, env=_env(platforms), stdout=log,
                                stderr=subprocess.STDOUT,
                                preexec_fn=lambda: os.nice(10))


def wait_child(name, proc, work, timeout):
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise PhaseFailed(f"child {name} timed out")
    if rc != 0:
        raise PhaseFailed(f"child {name} exited {rc}:\n"
                          f"{_tail(work / f'{name}.log')}")


def cli(args, log, platforms=GPU_PLATFORMS):
    """Start `tamcmc run ...` in a child process, output to `log`."""
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "tamcmc_tpu.cli"]
                                + args, cwd=ROOT, env=_env(platforms),
                                stdout=f, stderr=subprocess.STDOUT)


def cli_ok(args, log, timeout=900):
    p = cli(args, log)
    try:
        rc = p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        raise PhaseFailed(f"tamcmc {' '.join(args)} timed out")
    if rc != 0:
        raise PhaseFailed(f"tamcmc {' '.join(args)} exited {rc}:\n"
                          f"{_tail(log)}")


def phase_device(work, count):
    out = run_child("device", {}, work)
    dev = json.loads(out.split("DEVICE ", 1)[1].splitlines()[0])
    print(f"device: {dev}")
    if dev["platform"] != "gpu" or (count and dev["count"] != count):
        raise PhaseFailed(f"expected {count or 'some'} GPU device(s), "
                          f"JAX reports {dev}")
    return dev


def check_fit(outdir, phases, card, label, resumed=None):
    """A finished `tamcmc run` outdir: every phase's samples and .hdr,
    restore.npz and summary.json, all finite; the run on a GPU with the
    scan carry there.  Prints steps/s and wall per phase (for the
    `resumed` phase the CLI's figure divides the whole phase's steps by
    the remainder's wall time)."""
    m = metrics(outdir)
    start = [e for e in m if e["event"] == "run_start"][-1]
    if start["backend"] != "gpu":
        raise PhaseFailed(f"{label}: ran on {start['backend']}")
    for e in m:
        if e["event"] != "phase_end":
            continue
        if e["carry_platforms"] != ["gpu"]:
            raise PhaseFailed(f"{label}: phase {e['phase']} carry on "
                              f"{e['carry_platforms']}")
        note = (" (resumed: wall of the remainder only)"
                if e["phase"] == resumed else "")
        print(f"run {label} phase {e['phase']}: {e['steps']} steps in "
              f"{e['wall_s']} s ({e['steps_per_s']} steps/s, compile "
              f"included){note}, cold acceptance {e['cold_acceptance']}  "
              f"[{start['device_kind']}; {card}]")
    for ph in phases:
        s = read_samples(outdir, ph)
        z = np.load(pathlib.Path(outdir) / f"{ph}_chains.npz")
        if not (np.isfinite(s).all() and np.isfinite(z["logL"]).all()):
            raise PhaseFailed(f"{label}: non-finite {ph} samples")
        if s.shape[0] != z["logL"].shape[0]:
            raise PhaseFailed(f"{label}: {ph} holds {s.shape[0]} sample "
                              f"emits for {z['logL'].shape[0]} chain emits")
    ck = np.load(pathlib.Path(outdir) / "restore.npz")
    if not all(np.isfinite(ck[k]).all() for k in ck.files
               if k.startswith("state_")):
        raise PhaseFailed(f"{label}: non-finite checkpoint")
    rows = json.load(open(pathlib.Path(outdir) / "summary.json"))
    if not rows or not all(np.isfinite(r["median"]) for r in rows):
        raise PhaseFailed(f"{label}: bad summary.json")
    return s


def in_progress_phase(ckpt):
    """The phase of an intra-phase checkpoint at `ckpt`, or None (no file,
    a phase-boundary checkpoint, or a file being written)."""
    try:
        with np.load(ckpt) as z:
            if "meta_in_progress" in z.files and int(z["meta_in_progress"]):
                return str(z["phase"])
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        pass
    return None


def complete_copy(ckpt, snap):
    """Copy restore.npz and read back every member (zip CRCs): the copy's
    members, or None if the file changed under the copy."""
    try:
        shutil.copyfile(ckpt, snap)
        with np.load(snap) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None


def phase_run(work, card):
    # config 4: killed in Acquire right after an intra-phase checkpoint,
    # then resumed from that checkpoint
    c4 = work / "c4"
    args4 = ["run", "--outdir", str(c4), "--ckpt-every", "1"] \
        + demo_flags(CONFIG4) + run_flags(4)
    t0 = time.time()
    p = cli(args4, work / "c4_killed.log")
    ckpt, snap = c4 / "restore.npz", work / "restore_snapshot.npz"
    caught = None
    while p.poll() is None and time.time() - t0 < 900:
        if in_progress_phase(ckpt) == "A":
            vals = complete_copy(ckpt, snap)
            if vals is not None and str(vals["phase"]) == "A" and \
                    int(vals.get("meta_in_progress", 0)):
                p.kill()
                p.wait()
                caught = vals
                break
        time.sleep(0.1)
    if caught is None:
        p.kill()
        raise PhaseFailed("config 4: no mid-Acquire checkpoint was caught "
                          f"before the fit ended:\n"
                          f"{_tail(work / 'c4_killed.log')}")
    shutil.copyfile(snap, ckpt)      # the last complete checkpoint
    print(f"run config 4 killed after a mid-Acquire checkpoint "
          f"({int(caught['meta_emitted'])} records emitted) at "
          f"{time.time() - t0:.1f} s")
    t1 = time.time()
    cli_ok(args4 + ["--resume"], work / "c4_resumed.log")
    log = (work / "c4_resumed.log").read_text()
    if "mid-phase A" not in log:
        raise PhaseFailed(f"config 4 resume did not start mid-phase:\n"
                          f"{_tail(work / 'c4_resumed.log')}")
    s = check_fit(c4, ["B", "L", "A"], card, "config 4", resumed="A")
    check_acquire_shape(s, 4)
    print(f"run config 4 resumed mid-Acquire and finished in "
          f"{time.time() - t1:.1f} s; Acquire samples {s.shape} (emits, "
          f"walkers, params), finite")


def check_acquire_shape(samples, config):
    want = (ACQUIRE[config] // THIN, 64)
    if samples.shape[:2] != want:
        raise PhaseFailed(f"config {config}: Acquire holds "
                          f"{samples.shape[:2]} (emits, walkers), expected "
                          f"{want}")


def phase_config5(work, card):
    c5 = work / "c5"
    t0 = time.time()
    cli_ok(["run", "--outdir", str(c5)] + demo_flags(CONFIG5) + run_flags(5),
           work / "c5.log")
    s = check_fit(c5, ["B", "L", "A"], card, "config 5")
    check_acquire_shape(s, 5)
    print(f"run config 5 finished in {time.time() - t0:.1f} s; Acquire "
          f"samples {s.shape} (emits, walkers, params), finite")


def phase_gpu_tests(work, card):
    """The `gpu`-marked tests, on the card; every one must pass (a skip
    means the card was not seen)."""
    log = work / "gpu_tests.log"
    with open(log, "w") as f:
        p = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu",
                            "-p", "no:cacheprovider", "-rs",
                            str(ROOT / "tests" / "test_gpu.py")],
                           cwd=ROOT, env=_env(GPU_PLATFORMS), stdout=f,
                           stderr=subprocess.STDOUT, timeout=600)
    summary = log.read_text().strip().splitlines()[-1]
    if p.returncode != 0 or not pytest_all_passed(summary):
        raise PhaseFailed(f"gpu tests: {summary}\n{_tail(log)}")
    print(f"gpu tests: {summary}  [{card}]")


def pytest_all_passed(summary: str) -> bool:
    """Does pytest's last line report passes and nothing else (no skip,
    failure or error)?"""
    counts = dict((w, int(n)) for n, w in
                  re.findall(r"(\d+) (passed|failed|skipped|errors?|"
                             r"deselected|xfailed|xpassed)", summary))
    counts.pop("deselected", None)
    return counts.get("passed", 0) > 0 and set(counts) == {"passed"}


def phase_posterior(work, card):
    sys.path.insert(0, str(ROOT / "tools"))
    from golden_flagship import check
    for precision in ("f32", "bf16"):
        t0 = time.time()
        passed, bad, ran_on = check(precision,
                                    str(work / f"golden_{precision}.npz"),
                                    platform=GPU_PLATFORMS)
        print(f"posterior flagship golden {precision} on {ran_on}: "
              f"{'ok' if passed else 'FAIL'} ({len(bad)} of the golden's "
              f"parameters outside the z/std bands: {bad}) in "
              f"{time.time() - t0:.1f} s  [{card}]")
        if not passed or ran_on != "gpu":
            raise PhaseFailed(f"flagship golden {precision} failed on "
                              f"{ran_on}")


def parity_specs(work):
    configs = [dict(CONFIG4, TC=PARITY_TC)]
    return {prec: {"precision": prec, "configs": configs,
                   "out": str(work / f"ref_{prec}.npz")}
            for prec in ("f64", "f32", "bf16")}


def phase_parity(work, card, refs):
    for name, proc in refs.items():
        wait_child(name, proc, work, timeout=900)
    specs = parity_specs(work)
    for prec in ("f32", "bf16"):
        out = run_child("parity-gpu",
                        {"precision": prec, "configs": specs[prec]["configs"],
                         "ref_f64": specs["f64"]["out"],
                         "ref_cpu": specs[prec]["out"], "card": card}, work,
                        label=f"parity-gpu-{prec}")
        print(out.rstrip())


def phase_four(work, card):
    """Config 4 over a 4x1 (temp, chain) mesh with both sharded runners
    against the same fit on one card.  The GSPMD runner draws the same
    numbers as the local runner; the shardmap runner's per-walker draws are
    mesh-invariant but differ from the local runner's, so it is compared
    with itself on a 1x1 mesh.  Only reduction order then differs."""
    flags = demo_flags(CONFIG4) + ["--temps", "8", "--chains", "64",
             "--burnin", "20", "--learning", "0", "--acquire", "0",
             "--thin", "1", "--chunk", "20", "--no-report", "--max-rows", "3"]
    runs = {"one card": [], "gspmd 4x1": ["--mesh", "4x1"],
            "shardmap 1x1": ["--mesh", "1x1", "--runner", "shardmap"],
            "shardmap 4x1": ["--mesh", "4x1", "--runner", "shardmap"]}
    first = {}
    for label, extra in runs.items():
        out = work / label.replace(" ", "_")
        t0 = time.time()
        cli_ok(["run", "--outdir", str(out)] + flags + extra,
               work / f"{label.replace(' ', '_')}.log")
        s = read_samples(out, "B")
        z = np.load(out / "B_chains.npz")
        att = z["swap_att"][-1]
        if not (np.isfinite(s).all() and np.isfinite(z["logL"]).all()):
            raise PhaseFailed(f"{label}: non-finite outputs")
        if not (att[:-1] > 0).all():
            raise PhaseFailed(f"{label}: swap attempts {att.tolist()} miss "
                              "a rung pair")
        first[label] = (s[0], z["logL"][0, 0])
        dev = metrics(out)[0]
        print(f"four {label}: {time.time() - t0:.1f} s on {dev['devices']} "
              f"{dev['device_kind']} device(s), swap attempts per pair "
              f"{att[:-1].astype(int).tolist()}, finite  [{card}]")
    for a, b in (("gspmd 4x1", "one card"), ("shardmap 4x1", "shardmap 1x1")):
        agree = first_records_agree(*first[a], *first[b])
        print(f"four {a} vs {b}: first emitted cold-rung record agrees for "
              f"{int(agree.sum())}/{agree.size} walkers (rtol 1e-6 on theta0"
              f" and logL)")
        if agree.mean() < 0.9:
            raise PhaseFailed(f"{a} disagrees with {b}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its "
                         "one-card comparison")
    ap.add_argument("--child", nargs=2, metavar=("NAME", "SPEC"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (ROOT / "tamcmc_tpu").is_dir():
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    if args.child:
        name, spec = args.child
        return CHILDREN[name](json.loads(spec))

    sys.stdout.reconfigure(line_buffering=True)
    work = ROOT / ".smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    refs = {}
    try:
        from tamcmc_tpu.utils.backend import (add_gpu_xla_flags,
                                              card_name_and_power_limit)
        add_gpu_xla_flags()                    # inherited by every child
        card = card_name_and_power_limit()
        print(f"card: {card}")
        t0 = time.time()
        dev = phase_device(work, 4 if args.four else 1)
        if args.four:
            phase_four(work, card)
        else:
            refs = {f"parity-cpu-{prec}": start_child(
                        "parity-cpu", spec, work, "cpu", f"parity-cpu-{prec}")
                    for prec, spec in parity_specs(work).items()}
            for name, phase in (("run", phase_run),
                                ("parity", lambda w, c: phase_parity(w, c,
                                                                     refs)),
                                ("posterior", phase_posterior),
                                ("gpu-tests", phase_gpu_tests),
                                ("config5", phase_config5)):
                t1 = time.time()
                phase(work, card)
                print(f"phase {name} passed in {time.time() - t1:.1f} s "
                      f"(at {time.time() - t0:.1f} s)")
        print(f"all phases passed in {time.time() - t0:.1f} s  [{card}]")
    except (PhaseFailed, subprocess.SubprocessError, OSError) as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
