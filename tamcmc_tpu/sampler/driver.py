"""Scan driver + phase machine (Burn-in -> Learning -> Acquire).

Reference equivalent: `MALA::execute` + the phase logic in `main.cpp`
(SURVEY.md sections 2 "Phase machine", 3.1).  The per-iteration body of the
reference's hot loop becomes ONE jitted `lax.scan` step batched over (T, C);
the Python layer only orchestrates phases and chunked host transfers.

Thinning is structural: a scan "super-step" advances `thin` raw iterations
(inner scan) and emits one record — so device->host traffic is 1/thin of the
raw chain, matching the reference's buffered thinned writer (`outputs.cpp`).
Tempering swaps run every `hp.dN_mixing` raw iterations with alternating
parity sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from tamcmc_tpu.sampler.state import SamplerState, MALAHyper
from tamcmc_tpu.sampler.problem import Problem
from tamcmc_tpu.sampler.mala import mala_step
from tamcmc_tpu.sampler.tempering import tempering_swap


@dataclasses.dataclass(frozen=True)
class PhasePlan:
    """Iteration counts per phase; names follow the reference (B/L/A)."""
    burnin: int = 2000
    learning: int = 10000
    acquire: int = 20000
    thin: int = 10
    chunk: int = 200          # emitted records per device->host transfer

    def phases(self):
        return [("B", self.burnin, True), ("L", self.learning, True),
                ("A", self.acquire, False)]


def _raw_step(problem, hp, betas, adapt):
    """step(state, key) with `betas` closed over — the static-ladder form
    used by the sharded runners; the local runner routes through
    _raw_step_b so betas can be a traced argument (adaptive ladder)."""
    raw_b = _raw_step_b(problem, hp, adapt)

    def step(state, key):
        return raw_b(betas, state, key)
    return step


def _raw_step_b(problem, hp, adapt):
    def step(betas, state, key):
        k1, k2 = jax.random.split(key)
        state = mala_step(problem, hp, betas, state, k1, adapt=adapt)
        do_swap = (state.step % hp.dN_mixing) == 0
        parity = (state.step // hp.dN_mixing) % 2
        state = jax.lax.cond(
            do_swap,
            lambda s: tempering_swap(betas, s, k2, parity),
            lambda s: s,
            state)
        return state, None
    return step


def make_record(state: SamplerState):
    """Host-facing record of one emitted (thinned) sample: the cold rung's
    walkers plus adaptation telemetry.  theta/mu/cov are unmapped from the
    sampler's standardized u-space back to PHYSICAL parameters — everything
    downstream (writers, diagnostics, tests) sees reference-style units."""
    return {
        # (C, Df) coldest rung, physical units
        "theta0": state.u_center + state.u_scale * state.theta[0],
        "logL": state.logL,                          # (T, C)
        # per-rung logP chains: the reference writes logL AND logP for all
        # temperatures [U] (SURVEY.md section 2 "Outputs"); logP0 is kept as
        # the cold-rung convenience view for existing consumers
        "logP": state.logP,                          # (T, C)
        "logP0": state.logP[0],                      # (C,)
        "log_sigma": jnp.mean(state.log_sigma, 1),   # (T,) walker mean
        "acc_rate": jnp.mean(state.acc_rate, 1),     # (T,)
        "mu0": state.u_center + state.u_scale * jnp.mean(state.mu[0], 0),
        # Sigma trajectory (reference outputs.cpp writes the full
        # adaptation history [U]); the diagonal captures the per-param
        # proposal scales, full Sigma lives in every checkpoint.
        "cov_diag0": state.u_scale**2 * jnp.mean(jnp.diagonal(
            state.cov[0], axis1=-2, axis2=-1), 0),   # (Df,) physical
        "swap_att": state.nswap_att,                 # (T,) cumulative
        "swap_acc": state.nswap_acc,                 # (T,)
    }


def make_phase_runner(problem: Problem, hp: MALAHyper, betas,
                      adapt: bool, thin: int, n_emit: int,
                      betas_as_arg: bool = False):
    """Build a jitted (state, key) -> (state, outputs) running
    n_emit * thin raw iterations and emitting n_emit thinned records.

    betas_as_arg=True returns (betas, state, key) -> ... with the ladder a
    TRACED argument: the adaptive-ladder path updates betas between chunks
    on the host with zero recompiles (sampler/ladder.py).  The problem's
    data arrays are arguments of the jitted program too (Problem.data)."""
    def run(data, betas_t, state, key):
        raw = _raw_step_b(problem.with_data(data), hp, adapt)

        def super_step(state, key):
            keys = jax.random.split(key, thin)
            state, _ = jax.lax.scan(lambda s, k: raw(betas_t, s, k),
                                    state, keys)
            return state, make_record(state)

        keys = jax.random.split(key, n_emit)
        return jax.lax.scan(super_step, state, keys)

    jitted = jax.jit(run, donate_argnums=(2,))
    data = problem.data()
    if betas_as_arg:
        return lambda betas_t, state, key: jitted(data, betas_t, state, key)
    return lambda state, key: jitted(data, betas, state, key)


def resolve_emit_plan(n_steps: int, thin: int, chunk: int):
    """Chunk plan shared by the single-star and ensemble phase runners:
    (n_emit_total, chunk).  One compiled runner per (adapt, chunk) — the
    final partial chunk runs at the FULL chunk size (slight overshoot beats
    recompiling; an XLA compile of the scan costs far more than a few extra
    iterations) and the overshoot is logged, never silent: the
    extra records enter the returned posterior."""
    n_emit_total = max(n_steps // thin, 1)
    chunk = min(chunk, n_emit_total)
    overshoot = (-n_emit_total) % chunk
    if overshoot:
        n_emit_total += overshoot
        import sys
        print(f"note: requested {n_steps} steps rounds up to "
              f"{n_emit_total * thin} ({n_emit_total} emitted records, "
              f"chunk={chunk}); the extra {overshoot * thin} steps enter "
              "the returned posterior", file=sys.stderr)
    return n_emit_total, chunk


def run_phase(problem, hp, betas, state, key, n_steps, adapt=True, thin=1,
              chunk=200, on_chunk: Optional[Callable] = None,
              on_state: Optional[Callable] = None, mesh=None,
              already_emitted: int = 0, runner_kind: str = "gspmd",
              ladder: Optional[dict] = None):
    """Run one phase; returns (state, dict of stacked host outputs).

    on_chunk(outputs_dict) is called with device arrays after each chunk
    (for streaming writers/checkpoints); outputs are also accumulated and
    returned stacked on the emit axis.

    on_state(state, key, emitted) is called after each chunk with the
    carry state and the NEXT chunk's base key — checkpointing exactly this
    pair makes a mid-phase resume bitwise-identical to the uninterrupted
    run (the key stream restarts where it stopped).

    mesh: a (temp, chain) jax.sharding.Mesh routes the identical phase
    through the GSPMD-sharded runner (parallel/sharded.py) — the SURVEY
    section 5.8 scale-out path; state must already be placed with
    `shard_state`.

    already_emitted: skip this many already-emitted records (mid-phase
    resume; must be a multiple of the original run's chunk size).

    ladder: mutable adaptive-ladder state shared across phases when
    hp.adapt_ladder (sampler/ladder.py; local runner only):
    {"betas": (T,) np.ndarray, "updates": int, "last_att": (T,),
    "last_acc": (T,)}.  Adapting phases update it between chunks toward
    uniform pair swap acceptance; frozen phases just USE its betas.
    """
    n_emit_total, chunk = resolve_emit_plan(n_steps, thin, chunk)
    collected = []
    if already_emitted % chunk != 0:
        raise ValueError(f"already_emitted={already_emitted} is not a "
                         f"multiple of chunk={chunk}; resume would desync "
                         "the key stream")
    remaining = n_emit_total - already_emitted
    emitted = already_emitted
    if ladder is not None and mesh is not None:
        raise ValueError("adaptive ladder (hp.adapt_ladder) is local-runner "
                         "only; drop --mesh or --adapt-ladder")
    if mesh is not None:
        if runner_kind == "shardmap":
            # explicit-collective fallback (parallel/shardmap_runner.py):
            # same math, ppermute/pmean spelled out, mesh-invariant RNG
            from tamcmc_tpu.parallel.shardmap_runner import \
                make_shardmap_phase_runner
            runner = make_shardmap_phase_runner(problem, hp, betas, mesh,
                                                adapt, thin, chunk)
        else:
            from tamcmc_tpu.parallel.sharded import make_sharded_phase_runner
            runner = make_sharded_phase_runner(problem, hp, betas, mesh,
                                               adapt, thin, chunk)
    else:
        runner = make_phase_runner(problem, hp, betas, adapt, thin, chunk,
                                   betas_as_arg=ladder is not None)
    import numpy as np
    cur_betas = (jnp.asarray(ladder["betas"]) if ladder is not None
                 else None)
    while remaining > 0:
        key, sub = jax.random.split(key)
        if ladder is not None:
            state, outs = runner(cur_betas, state, sub)
        else:
            state, outs = runner(state, sub)
        emitted += chunk
        if ladder is not None and adapt:
            # between-chunk Vousden update toward uniform swap acceptance
            # (sampler/ladder.py) — host-side on the tiny (T,) counters,
            # zero recompiles (betas are a traced runner argument)
            from tamcmc_tpu.sampler.ladder import update_ladder
            att = np.asarray(state.nswap_att)
            acc = np.asarray(state.nswap_acc)
            ladder["updates"] += 1
            new = update_ladder(ladder["betas"],
                                att - ladder["last_att"],
                                acc - ladder["last_acc"],
                                ladder["updates"])
            ladder["last_att"], ladder["last_acc"] = att, acc
            ladder["betas"] = new
            cur_betas = jnp.asarray(new)
        if on_chunk is not None:
            on_chunk(outs)
        if on_state is not None:
            on_state(state, key, emitted)
        collected.append(jax.device_get(outs))
        remaining -= chunk
    if not collected:          # resumed exactly at the phase boundary
        return state, {}
    import numpy as np
    stacked = {k: np.concatenate([c[k] for c in collected], axis=0)
               for k in collected[0]}
    return state, stacked


def run_phases(problem, hp, betas, state, key, plan: PhasePlan,
               on_phase_end: Optional[Callable] = None):
    """Full B -> L -> A run. Returns (state, {phase: outputs})."""
    results = {}
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0:
            continue
        key, sub = jax.random.split(key)
        state, outs = run_phase(problem, hp, betas, state, sub, n_steps,
                                adapt=adapt, thin=plan.thin, chunk=plan.chunk)
        results[name] = outs
        if on_phase_end is not None:
            on_phase_end(name, state, outs)
    return state, results
