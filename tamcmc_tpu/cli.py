"""tamcmc CLI — run / export / model-eval / stats / list-models.

Reference equivalent: the `cpptamcmc` executable plus the post-processing
tools (`main.cpp`, `tools/bin2txt`, `tools/getmodel` [U]; SURVEY.md
sections 2, 3).  Workflow verbs:

  run         execute a fit (demo problem or TOML problem file), with the
              B/L/A phase machine, streamed binary outputs, checkpointing,
              and a matplotlib report        (= cpptamcmc execute)
  export      binary samples -> ASCII table  (= tools/bin2txt)
  model-eval  params -> model spectrum file  (= tools/getmodel)
  stats       posterior summary table        (= tools/stats, TAMCMC-tools)
  list-models print the model registry
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def _make_hyper(overrides: dict):
    """MALAHyper from a {field: value} dict, rejecting unknown names loudly
    (a silently-ignored sampler knob changes the posterior — SURVEY.md
    'hard parts' item 5 applied to the config system)."""
    import dataclasses
    from tamcmc_tpu.sampler.state import MALAHyper
    fields = {f.name for f in dataclasses.fields(MALAHyper)}
    bad = sorted(set(overrides) - fields)
    if bad:
        raise SystemExit(f"[sampler]: unknown MALAHyper field(s) {bad}; "
                         f"valid: {sorted(fields)}")
    return MALAHyper(**overrides)


def _sampler_cli_overrides(args):
    """CLI-level sampler knobs (override problem-file [sampler] values).
    A .cfg workflow's [MALA] block arrives via args.sampler_overrides
    (io/refconfig.py) and sits BELOW explicit CLI flags."""
    out = dict(getattr(args, "sampler_overrides", None) or {})
    if getattr(args, "lambda_temp", None) is not None:
        out["lambda_temp"] = args.lambda_temp
    if getattr(args, "dn_mixing", None) is not None:
        out["dN_mixing"] = args.dn_mixing
    if getattr(args, "no_drift", False):
        out["use_drift"] = False
    if getattr(args, "target_acc", None) is not None:
        out["target_acceptance"] = args.target_acc
    if getattr(args, "adapt_ladder", False):
        out["adapt_ladder"] = True
    return out


def _build_problem(args):
    import dataclasses
    import jax.numpy as jnp
    from tamcmc_tpu.demos import make_demo
    if args.demo:
        problem, hp, plan, meta = make_demo(
            args.demo, seed=args.seed,
            ngrid=getattr(args, "ngrid", None),
            n_orders=getattr(args, "n_orders", None))
        cli = _sampler_cli_overrides(args)
        if cli:
            hp = dataclasses.replace(hp, **cli)
        return problem, hp, plan, meta
    if args.problem:
        from tamcmc_tpu.io.problemfile import read_problem_file
        from tamcmc_tpu.io.data import read_spectrum
        from tamcmc_tpu.models import build_model
        from tamcmc_tpu.sampler.problem import Problem
        from tamcmc_tpu.sampler.state import MALAHyper
        from tamcmc_tpu.sampler.driver import PhasePlan
        if args.problem.endswith(".model"):
            # reference-style setup file: provisional semantic reader with a
            # loud banner (io/reference.py; byte-compat blocked on the
            # empty reference mount — SURVEY 5.6)
            from tamcmc_tpu.io.reference import read_model_provisional
            cfg = read_model_provisional(args.problem)
        else:
            cfg = read_problem_file(args.problem)
        fn, layout = build_model(cfg["model"], **cfg["spec_kwargs"])
        data_path = cfg["data"]
        if not pathlib.Path(data_path).is_absolute():
            data_path = str(pathlib.Path(args.problem).parent / data_path)
        d = read_spectrum(data_path)
        if cfg.get("auto_window") and \
                cfg["model"].lower().startswith("model_ms_global"):
            # rebuild with static c*Gamma truncation windows anchored at
            # params0 (problemfile.py `auto_window` — the reference's
            # truncation algorithm; grid must be uniform)
            nu_np = np.asarray(d["nu"], dtype=np.float64)
            step = float(np.median(np.diff(nu_np)))
            hint = (tuple(float(v) for v in cfg["params0"]),
                    float(nu_np[0]), step, int(nu_np.shape[0]),
                    float(cfg.get("window_margin", 10.0)))
            fn, layout = build_model(cfg["model"], window_hint=hint,
                                     **cfg["spec_kwargs"])
        nu = jnp.asarray(d["nu"], jnp.float32)
        spec = jnp.asarray(d["power"], jnp.float32)
        mask = None
        if cfg["freq_range"]:
            lo, hi = cfg["freq_range"]
            mask = jnp.asarray((d["nu"] >= lo) & (d["nu"] <= hi), jnp.float32)
        sigma = (jnp.asarray(d["sigma"], jnp.float32)
                 if "sigma" in d and cfg["likelihood"] == "chi_square" else None)
        extra = None
        if cfg.get("family_constraints", True):
            from tamcmc_tpu.stats.assemblers import build_family_constraints
            extra = build_family_constraints(cfg["model"], layout)
        # Auto prior rows: derive hyperparameters at setup or refuse loudly
        # (stats/auto_priors.py — never silently freeze a parameter the
        # reference would fit)
        from tamcmc_tpu.stats.auto_priors import (resolve_auto_priors,
                                                  AutoPriorError)
        try:
            cfg["priors"] = resolve_auto_priors(cfg["priors"], cfg["params0"],
                                                layout=layout, nu=nu,
                                                spec=spec)
        except AutoPriorError as e:
            raise SystemExit(f"{args.problem}: {e}")
        problem = Problem(model_fn=fn, layout=layout, priors=cfg["priors"],
                          nu=nu, spec=spec,
                          params0=jnp.asarray(cfg["params0"], jnp.float32),
                          likelihood=cfg["likelihood"], sigma_spec=sigma,
                          mask=mask, extra_logp=extra,
                          model_meta={"name": cfg["model"],
                                      "spec": getattr(fn, "_family_spec",
                                                      None)})
        sampler_cfg = dict(cfg.get("sampler", {}))
        sampler_cfg.update(_sampler_cli_overrides(args))
        hp = _make_hyper(sampler_cfg)
        ph = dict(cfg.get("phases", {}))
        n_temps = args.temps or ph.pop("temps", None) or 6
        n_chains = args.chains or ph.pop("chains", None) or 4
        plan = PhasePlan(burnin=args.burnin or ph.get("burnin", 2000),
                         learning=args.learning or ph.get("learning", 10000),
                         acquire=args.acquire or ph.get("acquire", 20000),
                         thin=args.thin or ph.get("thin", 10))
        return problem, hp, plan, {"n_temps": n_temps, "n_chains": n_chains}
    raise SystemExit("run: provide --demo NAME or --problem FILE")


def _check_resume_provenance(ckpt_path, **expect):
    """Refuse a --resume whose precision/runner differs from what the
    checkpoint was written under (round-4 advisor, medium).  Reads only the
    npz meta fields — called before any kernel traces, so the precision
    switch is still free to be set to the checkpoint's value.  Checkpoints
    predating the provenance meta are grandfathered with a note."""
    if not ckpt_path.exists():
        return
    z = np.load(str(ckpt_path), allow_pickle=False)
    for field, current in expect.items():
        key = f"meta_{field}"
        if key not in z.files:
            print(f"note: checkpoint predates {field} provenance; "
                  f"resuming under --{field} {current}", file=sys.stderr)
        elif str(z[key]) != current:
            raise SystemExit(
                f"refusing to resume: checkpoint {ckpt_path} was written "
                f"under --{field} {z[key]} but this run requests "
                f"--{field} {current}; mixing the two would splice samples "
                f"from different "
                f"{'likelihood precisions' if field == 'precision' else 'RNG protocols'} "
                f"into one posterior.  Re-run with --{field} {z[key]} "
                f"(or start a fresh outdir).")


def _report_available() -> bool:
    """The diagnostic report needs matplotlib, an optional extra: without
    it the fit still finishes, and the skipped report is said once."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("note: matplotlib is not installed; diagnostic report skipped",
              file=sys.stderr)
        return False
    return True


def _parse_mesh(spec: str):
    """'TxC' -> (n_temp_shards, n_chain_shards), e.g. '4x2'."""
    try:
        t, c = spec.lower().split("x")
        return int(t), int(c)
    except Exception:
        raise SystemExit(f"--mesh expects TEMPSxCHAINS (e.g. 4x2), got {spec!r}")


def cmd_run(args):
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.sampler import init_state, make_beta_ladder, run_phase
    from tamcmc_tpu.io.outputs import OutputWriter
    from tamcmc_tpu.io.checkpoint import save_checkpoint, load_checkpoint
    from tamcmc_tpu.diagnostics.summary import posterior_summary, format_summary

    debug = getattr(args, "debug", False)
    if debug:
        from tamcmc_tpu.utils.debug import enable_debug_mode
        enable_debug_mode()
    run_precision = getattr(args, "precision", "f32")
    run_runner = getattr(args, "runner", "gspmd")
    if args.resume:
        # provenance gate BEFORE precision is set/any model traces: a
        # checkpoint written under one precision/runner must not be resumed
        # under another — that would silently splice samples from two
        # slightly different likelihoods (bf16-vs-f32 profile stream) or
        # RNG protocols (gspmd global draws vs shardmap per-walker fold_in)
        # into one posterior (round-4 advisor, medium)
        _check_resume_provenance(pathlib.Path(args.outdir) / "restore.npz",
                                 precision=run_precision, runner=run_runner)
    if run_precision == "bf16":
        # must precede any model build: compiled programs bake precision in
        from tamcmc_tpu.ops.lorentzian import set_profile_precision
        set_profile_precision(args.precision)
    # --precision f64 (VALIDATION mode, the reference's double-precision
    # arithmetic [U]): enable_x64 + Problem.astype(f64) runs the whole
    # sampler f64.  x64 itself is enabled AFTER the problem is built (below):
    # demo problems generate synthetic data with jax.random, and enabling x64
    # first changes the draw stream — an f64 fit would then target DIFFERENT
    # data than the f32 fit it is validated against (tools/validate_f64.py).

    # --- multi-process / multi-chip bring-up (SURVEY 5.8; must precede any
    # backend-touching call so jax.distributed can claim its devices) ---
    multiproc = False
    if getattr(args, "distributed", False):
        from tamcmc_tpu.parallel.distributed import init_distributed
        multiproc = init_distributed()
    mesh = None
    if getattr(args, "mesh", None):
        from tamcmc_tpu.parallel.distributed import make_global_sampler_mesh
        nt, nc = _parse_mesh(args.mesh)
        mesh = make_global_sampler_mesh(nt, nc)
    elif getattr(args, "runner", "gspmd") != "gspmd":
        raise SystemExit("--runner selects the SHARDED execution strategy "
                         "and requires --mesh TxC; without a mesh the local "
                         "runner executes regardless")
    from tamcmc_tpu.utils.backend import ensure_gpu
    ensure_gpu()
    pid = jax.process_index() if multiproc else 0
    is_writer_proc = pid == 0

    problem, hp, plan, meta = _build_problem(args)
    if run_precision == "f64":
        import jax.numpy as _jnp
        jax.config.update("jax_enable_x64", True)
        problem = problem.astype(_jnp.float64)
    n_temps = args.temps or meta.get("n_temps", 6)
    n_chains = args.chains or meta.get("n_chains", 4)
    if mesh is not None:
        nt, nc = mesh.shape["temp"], mesh.shape["chain"]
        if n_temps % nt or n_chains % nc:
            raise SystemExit(f"mesh {nt}x{nc} must divide temps x chains "
                             f"= {n_temps}x{n_chains}")
    if args.burnin is not None:
        plan = __import__("dataclasses").replace(plan, burnin=args.burnin)
    if args.learning is not None:
        plan = __import__("dataclasses").replace(plan, learning=args.learning)
    if args.acquire is not None:
        plan = __import__("dataclasses").replace(plan, acquire=args.acquire)
    if args.thin is not None:
        plan = __import__("dataclasses").replace(plan, thin=args.thin)
    if getattr(args, "chunk", None):
        plan = __import__("dataclasses").replace(plan, chunk=args.chunk)

    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    betas = make_beta_ladder(n_temps, hp.lambda_temp)
    np.save(outdir / "betas.npy", np.asarray(betas))   # for tamcmc evidence
    ladder = None
    if hp.adapt_ladder:
        # Vousden et al. dynamic ladder (sampler/ladder.py): tuned during
        # Learning, frozen in Acquire; local runner only
        if getattr(args, "mesh", None):
            raise SystemExit("--adapt-ladder is local-runner only "
                             "(drop --mesh)")
        ladder = {"betas": np.asarray(betas, dtype=np.float64),
                  "updates": 0,
                  "last_att": np.zeros(n_temps),
                  "last_acc": np.zeros(n_temps)}
    key = jax.random.PRNGKey(args.seed)

    def _place(s):
        if mesh is None:
            return s
        from tamcmc_tpu.parallel.sharded import shard_state
        return shard_state(s, mesh)

    ckpt = outdir / "restore.npz"
    done_phases, mid_phase, mid_emitted, mid_key = [], None, 0, None
    if args.resume and ckpt.exists():
        # provenance (precision/runner match) was gated at the top of
        # cmd_run, before any kernel traced
        state, key, last_phase, cmeta = load_checkpoint(str(ckpt))
        if ladder is not None and "ladder_betas" in cmeta:
            ladder.update(
                betas=np.asarray(cmeta["ladder_betas"]),
                updates=int(cmeta["ladder_updates"]),
                last_att=np.asarray(cmeta["ladder_last_att"]),
                last_acc=np.asarray(cmeta["ladder_last_acc"]))
        state = _place(state)
        order = ["B", "L", "A"]
        if int(cmeta.get("in_progress", 0)):
            # mid-phase restore: `key` is the phase-INNER continuation key;
            # the outer key (for subsequent phases) travels in meta.
            mid_phase, mid_key = last_phase, key
            mid_emitted = int(cmeta.get("emitted", 0))
            key = jax.random.wrap_key_data(jnp.asarray(cmeta["outer_key"]))
            done_phases = order[:order.index(last_phase)] \
                if last_phase in order else []
            print(f"resumed from {ckpt} mid-phase {last_phase} "
                  f"({mid_emitted} records already emitted)")
        else:
            done_phases = order[:order.index(last_phase) + 1] \
                if last_phase in order else []
            print(f"resumed from {ckpt} after phase {last_phase}")
    else:
        key, sub = jax.random.split(key)
        init_scales = None
        err_table = getattr(args, "init_scale_table", None)
        if err_table:
            # errors_default.cfg semantics: per-parameter proposal seeds
            # (io/refconfig.py scales_from_errors)
            from tamcmc_tpu.io.refconfig import scales_from_errors
            init_scales = scales_from_errors(problem, err_table)
        state = _place(init_state(problem, hp, n_temps, n_chains, sub,
                                  init_scales=init_scales))

    from tamcmc_tpu.utils.metrics import MetricsLogger
    metrics = MetricsLogger(str(outdir / "metrics.jsonl"),
                            enabled=is_writer_proc)
    metrics.log("run_start", n_temps=n_temps, n_chains=n_chains,
                ndim_free=problem.ndim_free, seed=args.seed,
                mesh=getattr(args, "mesh", None) or "",
                runner=getattr(args, "runner", "gspmd"),
                precision=getattr(args, "precision", "f32"),
                processes=jax.process_count(),
                backend=jax.default_backend(),
                device_kind=jax.devices()[0].device_kind,
                devices=len(jax.devices()))
    # Multi-host: every process writes ITS slice of the (replicated)
    # cold-rung walker records — host-parallel IO, no duplication;
    # read_bin_samples merges the host shards transparently.
    walker_slice, shard_tag = None, ""
    if multiproc:
        from tamcmc_tpu.parallel.distributed import process_local_slice
        walker_slice = process_local_slice(n_chains)
        shard_tag = f"host{pid}"
    writer = OutputWriter(str(outdir), problem.free_names, n_temps, n_chains,
                          walker_slice=walker_slice, shard_tag=shard_tag,
                          keep_chains=is_writer_proc)
    ckpt_every = getattr(args, "ckpt_every", 0) or 0

    def _save_ckpt(s, k, phase, meta_d=None):
        # multi-host gather is a collective: ALL processes must enter it
        if mesh is not None:
            from tamcmc_tpu.parallel.sharded import gather_state_to_host
            s = gather_state_to_host(s)
        if is_writer_proc:
            meta_d = dict(meta_d or {})
            # provenance gate checked on --resume (see above)
            meta_d.setdefault("precision", run_precision)
            meta_d.setdefault("runner", run_runner)
            if ladder is not None:
                meta_d["ladder_betas"] = ladder["betas"]
                meta_d["ladder_updates"] = ladder["updates"]
                meta_d["ladder_last_att"] = ladder["last_att"]
                meta_d["ladder_last_acc"] = ladder["last_acc"]
            save_checkpoint(str(ckpt), s, k, phase=phase, meta=meta_d)

    # --- periodic in-run diagnostics (--report-every; SURVEY "end-of-phase
    # AND periodic" plots) — a rolling host buffer of recent chunks feeds
    # the same artifact set into <outdir>/inrun/, refreshed in place so a
    # killed mid-Learning run still leaves current plots.
    report_every = getattr(args, "report_every", 0) or 0
    if report_every and not _report_available():
        report_every = 0
    _report_buf, _report_chunks = [], [0]
    _REPORT_BUF_CAP = 100          # chunks kept for traces (bounded memory)
    _model_jit = [None]

    def _write_inrun_report(phase_name):
        from tamcmc_tpu.diagnostics.report import write_report
        inrun = outdir / "inrun"
        stacked = {k: np.concatenate([c[k] for c in _report_buf], axis=0)
                   for k in _report_buf[0]}
        model_cur = None
        th = stacked["theta0"]
        if hasattr(problem, "nu"):
            if _model_jit[0] is None:
                _model_jit[0] = jax.jit(
                    lambda x: problem.model_fn(problem.embed(x), problem.nu))
            med = jnp.asarray(np.median(th.reshape(-1, th.shape[-1]), axis=0),
                              jnp.float32)
            model_cur = np.asarray(_model_jit[0](med))
        made = write_report(inrun, {phase_name: stacked}, problem=problem,
                            names=problem.free_names,
                            model_at_median=model_cur)
        metrics.log("inrun_report", phase=phase_name,
                    chunks_seen=_report_chunks[0], artifacts=len(made))

    results = {}
    t0 = time.time()
    profiling = getattr(args, "profile", False)
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0 or name in done_phases:
            continue
        _report_buf.clear()        # traces must not span phase boundaries
        already = 0
        if name == mid_phase:
            already, sub = mid_emitted, mid_key
            writer.resume_phase(
                name, already * (walker_slice[1] - walker_slice[0]
                                 if walker_slice else n_chains))
        else:
            key, sub = jax.random.split(key)
        tp = time.time()
        import contextlib
        prof_ctx = (jax.profiler.trace(str(outdir / "jax_trace"))
                    if profiling and name == "A" else contextlib.nullcontext())

        def _on_chunk(o, _n=name):
            writer.append_chunk(_n, o)
            if debug:
                from tamcmc_tpu.utils.debug import chunk_finite_report
                bad = chunk_finite_report(o)
                if bad:
                    metrics.log("debug_nonfinite", phase=_n, **bad)
                    print(f"[debug] non-finite values in chunk: {bad}")
            if report_every and is_writer_proc:
                _report_buf.append({k: np.asarray(v) for k, v in o.items()})
                del _report_buf[:-_REPORT_BUF_CAP]
                _report_chunks[0] += 1
                if _report_chunks[0] % report_every == 0:
                    _write_inrun_report(_n)

        _chunk_no = [0]

        def _on_state(s, k, emitted, _n=name, _outer=None):
            if not ckpt_every:
                return
            _chunk_no[0] += 1
            if _chunk_no[0] % ckpt_every == 0:
                writer.save_partial(_n)
                _save_ckpt(s, k, _n, {
                    "in_progress": 1, "emitted": emitted,
                    "outer_key": np.asarray(jax.random.key_data(key))})

        try:
            with prof_ctx:
                state, outs = run_phase(
                    problem, hp, betas, state, sub, n_steps, adapt=adapt,
                    thin=plan.thin, chunk=plan.chunk,
                    on_chunk=_on_chunk, on_state=_on_state, mesh=mesh,
                    already_emitted=already,
                    runner_kind=getattr(args, "runner", "gspmd"),
                    ladder=ladder)
        except BaseException:
            writer.abort()      # drain buffers, no .hdr — resumable state
            raise
        writer.finalize_phase(name)
        if outs:
            results[name] = outs
        _save_ckpt(state, key, name)
        dt = time.time() - tp
        host_state = state
        if mesh is not None:
            from tamcmc_tpu.parallel.sharded import gather_state_to_host
            host_state = gather_state_to_host(state)
        acc_t = np.asarray(host_state.acc_rate).mean(axis=-1)   # walker mean
        acc = float(acc_t[0])
        swap = np.asarray(host_state.nswap_acc) / np.maximum(
            np.asarray(host_state.nswap_att), 1)
        metrics.log("phase_end", phase=name, steps=n_steps, wall_s=round(dt, 2),
                    steps_per_s=round(n_steps / dt, 1),
                    cold_acceptance=round(acc, 4),
                    acceptance=[round(float(a), 4) for a in acc_t],
                    swap_rates=[round(float(s), 4) for s in swap[:-1]],
                    sigma=[round(float(s), 6) for s in
                           np.exp(np.asarray(host_state.log_sigma)).mean(axis=-1)],
                    # where the scan carry lives: a CPU-committed input
                    # would have pulled the whole phase onto the host
                    carry_platforms=sorted({d.platform
                                            for d in state.theta.devices()}))
        print(f"phase {name}: {n_steps} steps in {dt:.1f}s "
              f"({n_steps / dt:.0f} it/s), cold acc={acc:.3f}")
    if ladder is not None:
        # the evidence tool integrates the A-phase logL chains over the
        # FINAL (frozen) ladder — overwrite the initial geometric one
        np.save(outdir / "betas.npy", np.asarray(ladder["betas"]))
        metrics.log("ladder_final",
                    betas=[round(float(b), 6) for b in ladder["betas"]],
                    updates=ladder["updates"])
    writer.close()
    if not is_writer_proc:
        print(f"process {pid}: sample shards written to {outdir}")
        return

    phase = "A" if "A" in results else (list(results)[-1] if results else None)
    if phase:
        th = results[phase]["theta0"]
        rows = posterior_summary(th, names=problem.free_names)
        print(format_summary(rows, max_rows=args.max_rows))
        with open(outdir / "summary.json", "w") as f:
            json.dump(rows, f, indent=1)
        if not args.no_report and _report_available():
            from tamcmc_tpu.diagnostics.report import write_report
            model_med = None
            if hasattr(problem, "nu"):
                med = jnp.asarray(np.median(th.reshape(-1, th.shape[-1]), axis=0),
                                  jnp.float32)
                full = problem.embed(med)
                model_med = np.asarray(jax.jit(problem.model_fn)(full, problem.nu))
            made = write_report(outdir, results, problem=problem,
                                names=problem.free_names,
                                model_at_median=model_med)
            print(f"report artifacts: {', '.join(made)}")
    print(f"total wall time {time.time() - t0:.1f}s; outputs in {outdir}")


def cmd_batch(args):
    """Multi-star runs from a presets table — the reference's
    `config_presets.cfg` workflow (SURVEY.md section 2 'Config system').
    Default: serial, one fit after another (the reference behaviour).
    --stacked: all stars advance in ONE vmapped program (aligned grids
    required — sampler/ensemble.py), S posteriors for one program's cost."""
    import argparse
    if getattr(args, "stacked", False) and getattr(args, "resume", False):
        # same provenance gate as cmd_run, before any kernel traces
        _check_resume_provenance(
            pathlib.Path(args.presets).parent / "stacked_restore.npz",
            precision=getattr(args, "precision", "f32"))
    if getattr(args, "precision", "f32") != "f32":
        # set ONCE here so both the per-star loop and the --stacked path
        # honour it (the stacked builder never routes through cmd_run)
        from tamcmc_tpu.ops.lorentzian import set_profile_precision
        set_profile_precision(args.precision)
    base = pathlib.Path(args.presets).parent
    cfg_defaults = {}
    err_table = None
    if args.presets.endswith(".cfg"):
        # reference-style workflow: config_presets.cfg rows (+ optional
        # config_default.cfg master and errors_default.cfg proposal seeds)
        # drive per-star fits from .cfg + .model files alone
        # (io/refconfig.py — provisional semantics, SURVEY 2 / 5.6)
        from tamcmc_tpu.io.refconfig import (
            read_config_presets_provisional, read_config_default_provisional,
            read_errors_default_provisional)
        try:
            stars = read_config_presets_provisional(args.presets)
            if getattr(args, "config", None):
                cfg_defaults = read_config_default_provisional(args.config)
            if getattr(args, "errors", None):
                err_table = read_errors_default_provisional(args.errors)
        except ValueError as e:
            raise SystemExit(str(e))
    else:
        import tomllib
        with open(args.presets, "rb") as f:
            doc = tomllib.load(f)
        stars = doc.get("star", [])
    if not stars:
        raise SystemExit(f"{args.presets}: no [[star]] entries")
    if getattr(args, "stacked", False):
        return _batch_stacked(args, stars, base)
    for i, star in enumerate(stars):
        ns = argparse.Namespace(
            demo=star.get("demo"), problem=star.get("problem"),
            seed=int(star.get("seed", 0)),
            temps=star.get("temps") or cfg_defaults.get("temps"),
            chains=star.get("chains") or cfg_defaults.get("chains"),
            burnin=star.get("burnin"), learning=star.get("learning"),
            acquire=star.get("acquire"),
            thin=star.get("thin") or cfg_defaults.get("thin"),
            outdir=str(base / star.get("outdir", f"star_{i}")),
            resume=args.resume, no_report=star.get("no_report", False),
            profile=False, max_rows=40,
            precision=getattr(args, "precision", "f32"),
            sampler_overrides=cfg_defaults.get("sampler") or None,
            init_scale_table=err_table)
        if ns.problem and not pathlib.Path(ns.problem).is_absolute():
            ns.problem = str(base / ns.problem)
        print(f"=== star {i + 1}/{len(stars)}: "
              f"{ns.problem or ns.demo} -> {ns.outdir} ===")
        cmd_run(ns)


def _batch_stacked(args, stars, base):
    """Aligned-grid stacked ensemble: ONE vmapped sampler over all stars
    (SURVEY.md section 2 'Ensemble/data parallelism' — the reference runs
    its presets table strictly SERIALLY; this is the rebuild's win).

    Streams per-star outputs chunk by chunk (bounded host memory) and
    checkpoints the stacked carry: `--resume` continues a killed ensemble
    bitwise, including mid-phase with --ckpt-every (same machinery as
    `tamcmc run`)."""
    import argparse
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.sampler import make_beta_ladder
    from tamcmc_tpu.sampler.ensemble import (
        validate_stackable, init_ensemble_state, run_ensemble_phase)
    from tamcmc_tpu.io.outputs import OutputWriter
    from tamcmc_tpu.io.checkpoint import save_checkpoint, load_checkpoint
    from tamcmc_tpu.diagnostics.summary import posterior_summary, format_summary
    from tamcmc_tpu.utils.backend import ensure_gpu

    ensure_gpu()
    problems, outdirs = [], []
    hp = plan = meta0 = None
    for i, star in enumerate(stars):
        ns = argparse.Namespace(
            demo=star.get("demo"), problem=star.get("problem"),
            seed=int(star.get("seed", 0)),
            temps=star.get("temps"), chains=star.get("chains"),
            burnin=star.get("burnin"), learning=star.get("learning"),
            acquire=star.get("acquire"), thin=star.get("thin"))
        if ns.problem and not pathlib.Path(ns.problem).is_absolute():
            ns.problem = str(base / ns.problem)
        problem, hp_i, plan_i, meta_i = _build_problem(ns)
        problems.append(problem)
        outdirs.append(pathlib.Path(base / star.get("outdir", f"star_{i}")))
        if i == 0:
            hp, plan, meta0 = hp_i, plan_i, meta_i
    try:
        validate_stackable(problems)
    except ValueError as e:
        raise SystemExit(
            f"batch --stacked: problems are not stackable ({e}); "
            "use the serial default for heterogeneous stars")
    n_temps = int(stars[0].get("temps", meta0.get("n_temps", 6)))
    n_chains = int(stars[0].get("chains", meta0.get("n_chains", 4)))
    betas = make_beta_ladder(n_temps, hp.lambda_temp)
    seed = int(stars[0].get("seed", 0))
    key = jax.random.PRNGKey(seed)

    ckpt = base / "stacked_restore.npz"
    run_precision = getattr(args, "precision", "f32")
    done_phases, mid_phase, mid_emitted, mid_key = [], None, 0, None
    if getattr(args, "resume", False) and ckpt.exists():
        # provenance gated in cmd_batch before any kernel traced
        states, key, last_phase, cmeta = load_checkpoint(str(ckpt))
        order = ["B", "L", "A"]
        if int(cmeta.get("in_progress", 0)):
            mid_phase, mid_key = last_phase, key
            mid_emitted = int(cmeta.get("emitted", 0))
            key = jax.random.wrap_key_data(jnp.asarray(cmeta["outer_key"]))
            done_phases = order[:order.index(last_phase)] \
                if last_phase in order else []
            print(f"stacked: resumed mid-phase {last_phase} "
                  f"({mid_emitted} records emitted)")
        else:
            done_phases = order[:order.index(last_phase) + 1] \
                if last_phase in order else []
            print(f"stacked: resumed after phase {last_phase}")
    else:
        key, sub = jax.random.split(key)
        states = init_ensemble_state(problems, hp, n_temps, n_chains, sub)

    for d in outdirs:
        d.mkdir(parents=True, exist_ok=True)
    writers = [OutputWriter(str(d), p.free_names, n_temps, n_chains)
               for d, p in zip(outdirs, problems)]
    ckpt_every = getattr(args, "ckpt_every", 0) or 0
    results = {}
    t0 = time.time()
    print(f"stacked ensemble: {len(problems)} stars x {n_temps} temps x "
          f"{n_chains} walkers, {problems[0].ndim_free} free dims")
    for name, n_steps, adapt in plan.phases():
        if n_steps <= 0 or name in done_phases:
            continue
        already = 0
        if name == mid_phase:
            already, sub = mid_emitted, mid_key
            for w in writers:
                w.resume_phase(name, already * n_chains)
        else:
            key, sub = jax.random.split(key)

        def _on_chunk(o, _n=name):
            for s, w in enumerate(writers):
                w.append_chunk(_n, {k: v[:, s] for k, v in o.items()})

        _cn = [0]

        def _on_state(s, k, emitted, _n=name):
            if not ckpt_every:
                return
            _cn[0] += 1
            if _cn[0] % ckpt_every == 0:
                for w in writers:
                    w.save_partial(_n)
                save_checkpoint(str(ckpt), s, k, phase=_n, meta={
                    "in_progress": 1, "emitted": emitted,
                    "precision": run_precision,
                    "outer_key": np.asarray(jax.random.key_data(key))})

        try:
            states, outs = run_ensemble_phase(
                problems, hp, betas, states, sub, n_steps, adapt=adapt,
                thin=plan.thin, chunk=plan.chunk, on_chunk=_on_chunk,
                on_state=_on_state, already_emitted=already)
        except BaseException:
            for w in writers:
                w.abort()
            raise
        for w in writers:
            w.finalize_phase(name)
        if outs:
            results[name] = outs
        save_checkpoint(str(ckpt), states, key, phase=name,
                        meta={"precision": run_precision})
    for w in writers:
        w.close()
    dt = time.time() - t0
    total = plan.burnin + plan.learning + plan.acquire
    print(f"ensemble done: {total} steps x {len(problems)} stars "
          f"in {dt:.1f}s")
    if "A" in results:
        for s, (problem, outdir) in enumerate(zip(problems, outdirs)):
            th = results["A"]["theta0"][:, s]
            rows = posterior_summary(th, names=problem.free_names)
            with open(outdir / "summary.json", "w") as f:
                json.dump(rows, f, indent=1)
            print(f"--- star {s}: {outdir} ---")
            print(format_summary(rows, max_rows=12))
    print(f"stacked outputs in {len(outdirs)} star directories")


def cmd_export(args):
    from tamcmc_tpu.io.outputs import read_bin_samples
    # --thin/--range act on the EMIT (iteration) axis, NOT the flat
    # (emit x walker)-interleaved record stream: the reference's bin2txt
    # thins records of a single chain [U], and striding the interleaved
    # array with a thin that is not a multiple of Nchains would instead
    # take an uneven walker subset per emit (round-3 VERDICT weak #4).
    chains, names = read_bin_samples(args.outdir, args.phase,
                                     with_chains=True)   # (E, C, Df)
    chains = chains[::args.thin]
    if args.range:
        lo, hi = (int(x) for x in args.range.split(":"))
        chains = chains[lo:hi]
    samples = chains.reshape(-1, chains.shape[-1])
    out = args.out or f"{args.outdir}/{args.phase}_samples.txt"
    np.savetxt(out, samples, header=" ".join(names))
    print(f"wrote {samples.shape[0]} x {samples.shape[1]} samples "
          f"({chains.shape[0]} emits x {chains.shape[1]} walkers) to {out}")


def cmd_model_eval(args):
    import jax
    import jax.numpy as jnp
    from tamcmc_tpu.utils.backend import ensure_gpu
    ensure_gpu()
    problem, hp, plan, meta = _build_problem(args)
    if args.params:
        params = np.loadtxt(args.params)
        full = jnp.asarray(params, jnp.float32)
        if params.shape[0] == problem.ndim_free:
            full = problem.embed(jnp.asarray(params, jnp.float32))
    else:
        full = problem.params0
    model = np.asarray(jax.jit(problem.model_fn)(full, problem.nu))
    out = args.out or "model_eval.txt"
    np.savetxt(out, np.column_stack([np.asarray(problem.nu),
                                     np.asarray(problem.spec), model]),
               header="frequency_uHz data_power model_power")
    print(f"wrote model spectrum ({model.shape[0]} bins) to {out}")


def cmd_stats(args):
    from tamcmc_tpu.io.outputs import read_bin_samples
    from tamcmc_tpu.diagnostics.summary import posterior_summary, format_summary
    samples, names = read_bin_samples(args.outdir, args.phase)
    rows = posterior_summary(samples, names=names)
    print(format_summary(rows, max_rows=args.max_rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


def cmd_evidence(args):
    """Thermodynamic-integration evidence from the tempered logL chains
    (diagnostics/evidence.py) — the temperature ladder the fit already ran
    makes ln Z nearly free."""
    from tamcmc_tpu.diagnostics.evidence import thermodynamic_evidence
    outdir = pathlib.Path(args.outdir)
    z = np.load(outdir / f"{args.phase}_chains.npz")
    if "logL" not in z.files:
        raise SystemExit(f"{args.phase}_chains.npz has no logL block")
    bpath = outdir / "betas.npy"
    if not bpath.exists():
        raise SystemExit(f"{bpath} missing (written by `tamcmc run`); "
                         "re-run the fit or supply an older outdir's ladder")
    res = thermodynamic_evidence(z["logL"], np.load(bpath),
                                 burn_frac=args.burn_frac)
    print(f"ln Z                = {res['logZ']:.4f}  "
          f"(+- {res['mc_err']:.4f} MC)")
    print(f"ln Z (sampled part) = {res['logZ_partial']:.4f}  "
          f"over beta in [{res['beta_min']:.5f}, 1]")
    print(f"prior-end slack     = {res['tail_slack']:.4f}  "
          f"(grow the ladder if this is not << the precision you need)")
    print("rung table (beta, E[lnL]):")
    for b, m in zip(res["betas_sorted"], res["mean_logL"]):
        print(f"  {b:9.5f}  {m:14.4f}")
    if args.json:
        out = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in res.items()}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


def cmd_make_example(args):
    """Export a built-in demo to the file-based workflow: spectrum data +
    problem.toml (+ injected truth) — the reference ships example setups
    the same way (test .model/.data files; SURVEY.md section 4)."""
    import dataclasses
    import numpy as np
    from tamcmc_tpu.demos import make_demo
    from tamcmc_tpu.io.data import write_spectrum
    from tamcmc_tpu.io.problemfile import write_problem_file
    from tamcmc_tpu.sampler.state import MALAHyper

    problem, hp, plan, meta = make_demo(args.demo, seed=args.seed,
                                        ngrid=args.ngrid)
    if "model" not in meta:
        raise SystemExit(f"demo '{args.demo}' does not support export")
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    data_name = "spectrum.npz" if args.npz else "spectrum.data"
    sigma = getattr(problem, "sigma_spec", None)
    write_spectrum(str(outdir / data_name), np.asarray(problem.nu),
                   np.asarray(problem.spec),
                   sigma=None if sigma is None else np.asarray(sigma))

    defaults = MALAHyper()
    sampler = {f.name: getattr(hp, f.name) for f in dataclasses.fields(hp)
               if getattr(hp, f.name) != getattr(defaults, f.name)}
    phases = {"burnin": plan.burnin, "learning": plan.learning,
              "acquire": plan.acquire, "thin": plan.thin,
              "temps": meta["n_temps"], "chains": meta["n_chains"]}
    write_problem_file(str(outdir / "problem.toml"), meta["model"],
                       np.asarray(problem.params0), problem.priors,
                       likelihood=problem.likelihood, data=data_name,
                       spec_kwargs=meta.get("spec_kwargs"),
                       sampler=sampler, phases=phases)
    if getattr(args, "model_format", False):
        from tamcmc_tpu.io.reference import write_model_provisional
        write_model_provisional(str(outdir / "problem.model"), meta["model"],
                                np.asarray(problem.params0), problem.priors,
                                likelihood=problem.likelihood, data=data_name,
                                spec_kwargs=meta.get("spec_kwargs"))
    if "truth" in meta:
        np.savetxt(outdir / "truth.txt", np.asarray(meta["truth"]),
                   header="injected parameter values (full ABI vector)")
    print(f"example '{args.demo}' written to {outdir}/ "
          f"(run: tamcmc run --problem {outdir / 'problem.toml'} "
          f"--outdir {outdir / 'fit'})")


def cmd_compare(args):
    """Posterior-moment parity harness (SURVEY stage 8 / BASELINE metric):
    compare two sample sets — two run outdirs, or an outdir vs an ASCII
    table (ours via `tamcmc export`, the reference's via bin2txt [U]) —
    with ESS-aware z-scores; exit 1 on inconsistency."""
    from tamcmc_tpu.diagnostics.compare import (
        compare_posteriors, format_comparison, load_ascii_samples)
    from tamcmc_tpu.io.outputs import read_bin_samples

    def load(src):
        if pathlib.Path(src).is_dir():
            # (E, C, D) per-walker chains: _moments' ESS must see each
            # walker's own autocorrelated trajectory — the flat (E*C, D)
            # epoch-major interleave overestimates ESS by ~tau and inflates
            # z-scores into spurious INCONSISTENT verdicts
            return read_bin_samples(src, args.phase, with_chains=True)
        return load_ascii_samples(src)

    sa, na = load(args.a)
    sb, nb = load(args.b)
    res = compare_posteriors(sa, na, sb, nb, z_threshold=args.z,
                             std_ratio_threshold=args.std_ratio)
    print(format_comparison(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    if not res["consistent"]:
        raise SystemExit(1)


def cmd_validate(args):
    """Lint a problem file before a fit — the errors_default.cfg analog
    (io/validate.py): every setup problem reported at once, host-side only."""
    from tamcmc_tpu.io.validate import validate_problem
    any_err = False
    for path in args.files:
        errors, warns = validate_problem(path)
        status = "FAIL" if errors else ("WARN" if warns else "OK")
        print(f"{path}: {status}")
        for e in errors:
            print(f"  error: {e}")
        for w in warns:
            print(f"  warning: {w}")
        any_err = any_err or bool(errors)
    if any_err:
        raise SystemExit(1)


def cmd_list_models(args):
    from tamcmc_tpu.models import list_models
    for m in list_models():
        print(m)


def main(argv=None):
    from tamcmc_tpu.utils.backend import request_gpu_unless_told
    from tamcmc_tpu.utils.cache import enable_compile_cache
    request_gpu_unless_told()
    enable_compile_cache()
    ap = argparse.ArgumentParser(prog="tamcmc",
                                 description="TAMCMC peak-bagging engine "
                                             "in JAX")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_problem_args(p):
        p.add_argument("--demo", help="built-in demo problem name")
        p.add_argument("--ngrid", type=int,
                       help="override a demo's frequency-grid size (CI "
                            "scaling; ignored with --problem)")
        p.add_argument("--n-orders", type=int, dest="n_orders",
                       help="override a demo's radial-order count")
        p.add_argument("--problem", help="TOML problem file")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--temps", type=int)
        p.add_argument("--chains", type=int)
        p.add_argument("--burnin", type=int)
        p.add_argument("--learning", type=int)
        p.add_argument("--acquire", type=int)
        p.add_argument("--thin", type=int)
        p.add_argument("--lambda-temp", type=float, dest="lambda_temp",
                       help="geometric temperature-ladder ratio T_k = λ^k")
        p.add_argument("--dn-mixing", type=int, dest="dn_mixing",
                       help="tempering swap cadence (iterations)")
        p.add_argument("--no-drift", action="store_true",
                       help="disable the MALA drift (adaptive RW-Metropolis, "
                            "the reference's default operating mode)")
        p.add_argument("--target-acc", type=float, dest="target_acc",
                       help="adaptation target acceptance rate")

    pr = sub.add_parser("run", help="execute a fit (B/L/A phases)")
    add_problem_args(pr)
    pr.add_argument("--outdir", required=True)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--no-report", action="store_true")
    pr.add_argument("--profile", action="store_true",
                    help="capture a jax.profiler trace of the Acquire phase")
    pr.add_argument("--debug", action="store_true",
                    help="debug mode: jax_debug_nans + per-chunk finite "
                         "checks surfaced in metrics.jsonl (SURVEY 5.2)")
    pr.add_argument("--mesh",
                    help="shard the run over a TEMPSxCHAINS device mesh, "
                         "e.g. 4x2 (SURVEY 5.8 scale-out: tempering swaps "
                         "become neighbour collectives on the temp axis)")
    pr.add_argument("--runner", choices=("gspmd", "shardmap"),
                    default="gspmd",
                    help="sharded execution strategy: 'gspmd' jits the "
                         "batched step with sharding annotations (XLA "
                         "chooses collectives); 'shardmap' is the explicit "
                         "per-shard implementation with hand-placed "
                         "ppermute/pmean collectives and mesh-invariant "
                         "RNG (parallel/shardmap_runner.py)")
    pr.add_argument("--distributed", action="store_true",
                    help="multi-host: initialise jax.distributed from "
                         "JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/"
                         "JAX_PROCESS_ID before building the mesh; each "
                         "host writes its own sample shard")
    pr.add_argument("--adapt-ladder", action="store_true", dest="adapt_ladder",
                    help="BEYOND REFERENCE: tune per-rung temperatures "
                         "toward uniform swap acceptance during Learning "
                         "(Vousden et al. 2016 dynamic selection), frozen "
                         "in Acquire; local runner only (no --mesh); the "
                         "reference's ladder is fixed geometric")
    pr.add_argument("--chunk", type=int,
                    help="emitted records per device->host transfer "
                         "(default 200); smaller = finer checkpoint/"
                         "report granularity, more launch overhead")
    pr.add_argument("--ckpt-every", type=int, dest="ckpt_every", default=0,
                    help="intra-phase checkpoint cadence in chunks (0 = "
                         "phase boundaries only); a killed run resumes "
                         "bitwise from the last chunk checkpoint")
    pr.add_argument("--report-every", type=int, dest="report_every", default=0,
                    help="periodic IN-RUN diagnostics cadence in chunks "
                         "(0 = end-of-run only): refreshes the artifact set "
                         "(spectrum+current-median model, traces, "
                         "acceptance) under <outdir>/inrun/ so a killed "
                         "month-long fit still leaves plots (reference "
                         "diagnostics.cpp periodic plots [U])")
    pr.add_argument("--precision", choices=("f32", "bf16", "f64"),
                    default="f32",
                    help="f32 (default contract) | bf16: Lorentzian profile-"
                         "stream arithmetic in bfloat16 with f32 "
                         "accumulation, posterior-validated vs f32 on "
                         "BASELINE configs 1-3 (tools/validate_bf16.py) | "
                         "f64: VALIDATION mode (enable_x64, whole sampler "
                         "double precision — the reference's arithmetic "
                         "[U]; tools/validate_f64.py parity anchor)")
    pr.add_argument("--max-rows", type=int, default=40)
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("batch", help="run a presets table of stars serially "
                                      "(reference config_presets.cfg workflow)")
    pb.add_argument("--presets", required=True,
                    help="TOML with [[star]] entries: problem/demo, outdir, "
                         "optional overrides (temps, chains, burnin, ...); "
                         "a .cfg path is read as a PROVISIONAL reference "
                         "config_presets table (io/refconfig.py)")
    pb.add_argument("--config",
                    help="provisional config_default.cfg: master sampler/"
                         "phase defaults applied below per-star overrides")
    pb.add_argument("--errors",
                    help="provisional errors_default.cfg: per-parameter "
                         "initial proposal sigmas")
    pb.add_argument("--resume", action="store_true")
    pb.add_argument("--precision", choices=("f32", "bf16"), default="f32",
                    help="Lorentzian profile-stream arithmetic for every "
                         "star (see run --precision)")
    pb.add_argument("--stacked", action="store_true",
                    help="advance ALL stars in one vmapped program "
                         "(requires aligned grids + shared model family; "
                         "S posteriors for one program's launch cost)")
    pb.add_argument("--ckpt-every", type=int, dest="ckpt_every", default=0,
                    help="stacked mode: intra-phase checkpoint cadence in "
                         "chunks (same semantics as run --ckpt-every)")
    pb.set_defaults(fn=cmd_batch)

    pe = sub.add_parser("export", help="binary samples -> ASCII (bin2txt)")
    pe.add_argument("--outdir", required=True)
    pe.add_argument("--phase", default="A")
    pe.add_argument("--thin", type=int, default=1)
    pe.add_argument("--range", help="lo:hi record range")
    pe.add_argument("--out")
    pe.set_defaults(fn=cmd_export)

    pm = sub.add_parser("model-eval", help="params -> model spectrum (getmodel)")
    add_problem_args(pm)
    pm.add_argument("--params", help="ASCII parameter vector file")
    pm.add_argument("--out")
    pm.set_defaults(fn=cmd_model_eval)

    ps = sub.add_parser("stats", help="posterior summary (quantiles, ESS)")
    ps.add_argument("--outdir", required=True)
    ps.add_argument("--phase", default="A")
    ps.add_argument("--max-rows", type=int, default=60)
    ps.add_argument("--json")
    ps.set_defaults(fn=cmd_stats)

    pv = sub.add_parser("evidence",
                        help="thermodynamic-integration ln Z from the "
                             "tempered logL chains (free with the ladder)")
    pv.add_argument("--outdir", required=True)
    pv.add_argument("--phase", default="A")
    pv.add_argument("--burn-frac", type=float, dest="burn_frac", default=0.0)
    pv.add_argument("--json")
    pv.set_defaults(fn=cmd_evidence)

    px = sub.add_parser("make-example",
                        help="export a built-in demo as problem.toml + "
                             "spectrum data (reference-style example setup)")
    px.add_argument("--demo", required=True)
    px.add_argument("--outdir", required=True)
    px.add_argument("--seed", type=int, default=0)
    px.add_argument("--ngrid", type=int,
                    help="override the demo's frequency-grid size")
    px.add_argument("--npz", action="store_true",
                    help="write spectrum.npz instead of ASCII .data")
    px.add_argument("--model-format", action="store_true", dest="model_format",
                    help="also export problem.model in the provisional "
                         "reference setup format (io/reference.py)")
    px.set_defaults(fn=cmd_make_example)

    pq = sub.add_parser("compare",
                        help="posterior-moment parity check between two "
                             "sample sets (run outdirs or ASCII tables)")
    pq.add_argument("a", help="run outdir or ASCII sample table")
    pq.add_argument("b", help="run outdir or ASCII sample table")
    pq.add_argument("--phase", default="A")
    pq.add_argument("--z", type=float, default=3.0,
                    help="max |z| for per-param mean agreement")
    pq.add_argument("--std-ratio", type=float, default=1.5, dest="std_ratio",
                    help="allowed posterior-std ratio band [1/r, r]")
    pq.add_argument("--json")
    pq.set_defaults(fn=cmd_compare)

    pc = sub.add_parser("validate",
                        help="lint problem files (priors, data, start point, "
                             "sampler/phase sections) before running")
    pc.add_argument("files", nargs="+", help="problem .toml / .model files")
    pc.set_defaults(fn=cmd_validate)

    pl = sub.add_parser("list-models", help="print model registry")
    pl.set_defaults(fn=cmd_list_models)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
