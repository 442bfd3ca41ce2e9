"""Output writers: thinned posterior samples + adaptation trajectories.

Reference equivalent: the buffered binary writers of `outputs.cpp` [U]
(SURVEY.md section 2 "Outputs"): samples of the coldest chain (thinned),
sigma/mu/Sigma adaptation trajectories, acceptance and swap rates, logL
chains for all temperatures, with `.hdr` sidecar headers.

Format here:
  {phase}_samples.bin  — raw little-endian float64 records, one row per
                         (emit, walker): Df values.  `.hdr` sidecar is ASCII:
                         Nvars, Nsamples, column names — enough for the
                         `tamcmc export` tool (reference bin2txt parity).
  {phase}_chains.npz   — logL/logP (emit, T, C; all rungs — reference
                         outputs.cpp writes both chains for every
                         temperature [U]), logP0, log_sigma, acc_rate, mu0,
                         cov_diag0 (emit, Df), swap_att/swap_acc (emit, T;
                         cumulative counters — rates are diffs over emits)

Multi-host runs: each process constructs its writer with `walker_slice`
(its rows of the replicated cold-rung record, from
`parallel.distributed.process_local_slice`) and a `shard_tag` ("hostK") —
samples land in {phase}_samples.hostK.bin and `read_bin_samples` merges the
shards transparently.  Chain diagnostics are replicated, so only the tag-less
(or host0) writer keeps them.

Mid-phase resume: `save_partial` persists the in-memory chain buffers next
to the flushed .bin; `resume_phase` truncates the .bin to the checkpointed
record count (a crash can leave extra records past the checkpoint) and
reloads the buffers — together with the driver's (state, key) checkpoint the
continuation is bitwise-identical (SURVEY.md section 5.4).

A C++ implementation of the record writer lives in native/ (used when built;
this module transparently falls back to numpy).
"""

from __future__ import annotations

import glob
import os
import pathlib

import numpy as np


class OutputWriter:
    def __init__(self, outdir: str, param_names, n_temps: int, n_chains: int,
                 walker_slice=None, shard_tag: str = "",
                 keep_chains: bool = True):
        self.outdir = pathlib.Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.param_names = list(param_names)
        self.n_temps = n_temps
        self.n_chains = n_chains
        self.walker_slice = walker_slice      # (start, stop) into the C axis
        self.shard_tag = shard_tag            # "" or e.g. "host1"
        self.keep_chains = keep_chains
        self._bin_handles = {}
        self._counts = {}
        self._chain_buffers = {}

    def _bin_path(self, phase: str) -> pathlib.Path:
        tag = f".{self.shard_tag}" if self.shard_tag else ""
        return self.outdir / f"{phase}_samples{tag}.bin"

    def _hdr_path(self, phase: str) -> pathlib.Path:
        tag = f".{self.shard_tag}" if self.shard_tag else ""
        return self.outdir / f"{phase}_samples{tag}.hdr"

    def _partial_path(self, phase: str) -> pathlib.Path:
        return self.outdir / f"{phase}_chains_partial.npz"

    # --- streaming API (called per chunk from the driver) ---
    def append_chunk(self, phase: str, outs: dict):
        """outs: host dict from run_phase — theta0 (E, C, Df), logL (E, T, C),
        logP0 (E, C), log_sigma (E, T), acc_rate (E, T), mu0 (E, Df)."""
        theta0 = np.asarray(outs["theta0"], dtype=np.float64)
        if self.walker_slice is not None:
            lo, hi = self.walker_slice
            theta0 = theta0[:, lo:hi]
        E, C, Df = theta0.shape
        f = self._bin_handles.get(phase)
        if f is None:
            f = self._open_writer(phase, Df)
            self._bin_handles[phase] = f
            self._counts.setdefault(phase, 0)
            self._chain_buffers.setdefault(phase, [])
        records = theta0.reshape(E * C, Df)
        if hasattr(f, "append"):           # native async writer
            f.append(records)
        else:
            f.write(records.astype("<f8").tobytes())
        self._counts[phase] += E * C
        if self.keep_chains:
            self._chain_buffers[phase].append(
                {k: np.asarray(v) for k, v in outs.items() if k != "theta0"})

    def _open_writer(self, phase: str, nvars: int, append: bool = False):
        """Prefer the native async double-buffered writer (native/recordio);
        fall back to a plain Python file handle.  Resumed phases append with
        a plain handle (the native writer owns its file exclusively)."""
        path = self._bin_path(phase)
        if append:
            return open(path, "ab")
        try:
            from tamcmc_tpu.io.native import NativeRecordWriter
            return NativeRecordWriter(str(path), nvars)
        except Exception:
            return open(path, "wb")

    # --- mid-phase checkpoint support ---
    def save_partial(self, phase: str):
        """Flush the .bin and persist chain buffers; pairs with the sampler
        checkpoint taken at the same chunk boundary."""
        f = self._bin_handles.get(phase)
        if f is not None and hasattr(f, "flush"):
            f.flush()
        if self.keep_chains and self._chain_buffers.get(phase):
            bufs = self._chain_buffers[phase]
            stacked = {k: np.concatenate([b[k] for b in bufs], axis=0)
                       for k in bufs[0]}
            stacked["__count__"] = np.asarray(self._counts[phase])
            np.savez(self._partial_path(phase), **stacked)

    def resume_phase(self, phase: str, n_records: int):
        """Re-open a partially-written phase at exactly n_records records
        (truncating whatever a crash wrote past the checkpoint)."""
        Df = len(self.param_names)
        path = self._bin_path(phase)
        nbytes = n_records * Df * 8
        if path.exists():
            with open(path, "rb+") as f:
                f.truncate(nbytes)
        else:
            raise FileNotFoundError(f"cannot resume: {path} missing")
        self._bin_handles[phase] = self._open_writer(phase, Df, append=True)
        self._counts[phase] = n_records
        self._chain_buffers[phase] = []
        pp = self._partial_path(phase)
        if self.keep_chains and pp.exists():
            # a crash between save_partial and the checkpoint leaves chain
            # records past the checkpoint: keep the checkpointed emits only
            per_emit = (self.walker_slice[1] - self.walker_slice[0]
                        if self.walker_slice else self.n_chains)
            n_emit = n_records // per_emit
            z = np.load(pp)
            buf = {k: z[k][:n_emit] for k in z.files if k != "__count__"}
            if buf:
                self._chain_buffers[phase].append(buf)

    def finalize_phase(self, phase: str):
        if phase not in self._bin_handles:
            return
        self._bin_handles[phase].close()
        del self._bin_handles[phase]
        with open(self._hdr_path(phase), "w") as h:
            h.write("# tamcmc-tpu samples header\n")
            h.write(f"Nvars= {len(self.param_names)}\n")
            h.write(f"Nsamples= {self._counts[phase]}\n")
            h.write(f"Nchains= {self.n_chains}\n")
            h.write("variable_names= " + " ".join(self.param_names) + "\n")
            h.write("dtype= float64_le\n")
        if self.keep_chains:
            bufs = self._chain_buffers.pop(phase)
            stacked = {k: np.concatenate([b[k] for b in bufs], axis=0)
                       for k in bufs[0]}
            np.savez_compressed(self.outdir / f"{phase}_chains.npz", **stacked)
        pp = self._partial_path(phase)
        if pp.exists():
            pp.unlink()

    def abort(self):
        """Close bin handles WITHOUT finalizing (no .hdr, buffers drained).
        Called on an in-process crash so the interrupted phase is left
        exactly as a killed process would leave it after its last flush —
        resume_phase then truncates to the checkpoint."""
        for f in list(self._bin_handles.values()):
            try:
                f.close()
            except Exception:
                pass
        self._bin_handles.clear()

    def close(self):
        for phase in list(self._bin_handles):
            self.finalize_phase(phase)


def _read_one(bin_path: pathlib.Path, hdr_path: pathlib.Path):
    hdr = {}
    with open(hdr_path) as f:
        for line in f:
            if line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            hdr[k.strip()] = v.strip()
    nvars = int(hdr["Nvars"])
    names = hdr["variable_names"].split()
    raw = np.fromfile(bin_path, dtype="<f8")
    n = raw.size // nvars
    assert n == int(hdr["Nsamples"]), \
        f"bin/hdr mismatch: {n} records vs {hdr['Nsamples']}"
    return raw.reshape(n, nvars), names, int(hdr.get("Nchains", 0))


def read_bin_samples(outdir: str, phase: str, with_chains: bool = False):
    """Read back {phase}_samples.bin via its .hdr → (samples, names).
    This is the reference's bin2txt input path (SURVEY.md section 3.3).
    Multi-host runs leave per-process shards ({phase}_samples.hostK.bin);
    they are concatenated in host order.

    with_chains=True returns samples reshaped to (E, C, D) using the .hdr's
    Nchains (shards concatenate on the walker axis) — per-walker chain
    structure is what autocorrelation-aware consumers (ESS, tamcmc compare)
    need: the flat (E*C, D) interleaving destroys per-walker
    autocorrelation and inflates ESS by ~tau."""
    outdir = pathlib.Path(outdir)

    def _chains(s, nchains):
        n = s.shape[0]
        if nchains and n % nchains == 0:
            return s.reshape(n // nchains, nchains, s.shape[1])
        # unknown layout (legacy .hdr without Nchains, or a record count a
        # crash left non-divisible): one flat pseudo-chain.  Warn — emit-axis
        # consumers (export --thin, ESS) then operate on the INTERLEAVED
        # record stream, which is exactly the uneven-walker-subset striding
        # the chain-aware path exists to avoid (round-4 advisor, low).
        import sys
        print(f"warning: {phase}_samples has no usable Nchains "
              f"(Nchains={nchains}, {n} records); treating the interleaved "
              "record stream as one pseudo-chain — thinning/ESS will stride "
              "across walkers", file=sys.stderr)
        return s[:, None, :]

    single = outdir / f"{phase}_samples.bin"
    if single.exists():
        s, names, nchains = _read_one(single, outdir / f"{phase}_samples.hdr")
        return (_chains(s, nchains), names) if with_chains else (s, names)
    shards = sorted(glob.glob(str(outdir / f"{phase}_samples.host*.bin")))
    if not shards:
        raise FileNotFoundError(f"no {phase}_samples[.host*].bin in {outdir}")
    parts, names = [], None
    for b in shards:
        s, names, nchains = _read_one(pathlib.Path(b),
                                      pathlib.Path(b[:-4] + ".hdr"))
        parts.append(_chains(s, nchains) if with_chains else s)
    if with_chains:
        emits = {p.shape[0] for p in parts}
        if len(emits) == 1:
            return np.concatenate(parts, axis=1), names
        # desynced shards (aborted host): flatten back to pseudo-chains
        import sys
        print(f"warning: host shards of {phase}_samples are desynced "
              f"(emit counts {sorted(emits)}); flattening to pseudo-chains — "
              "thinning/ESS will stride across walkers", file=sys.stderr)
        parts = [p.reshape(-1, p.shape[-1])[:, None, :] for p in parts]
        return np.concatenate(parts, axis=0), names
    return np.concatenate(parts, axis=0), names
