"""Problem: immutable bundle of (model, likelihood, priors, data).

Replaces the reference's mutable `Model_def` state holder
(`model_def.cpp` [U]; SURVEY.md section 2): model/likelihood/prior dispatch
is resolved ONCE at build time; inside jit there is only a pure function
`logparts_and_grad`.  Fixed ("Fix"/"Auto") parameters are excluded from the
sampling space: the sampler works in the Df-dim free subspace and `embed`
scatters free values into the full parameter vector.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tamcmc_tpu.stats.priors import PriorTable
from tamcmc_tpu.stats.likelihoods import get_likelihood
from tamcmc_tpu.utils.blocks import BlockLayout


@dataclasses.dataclass(frozen=True)
class Problem:
    model_fn: Callable            # (full_params, nu) -> model spectrum
    layout: BlockLayout
    priors: PriorTable
    nu: jnp.ndarray               # (N,) frequency grid
    spec: jnp.ndarray             # (N,) observed power spectrum
    params0: jnp.ndarray          # (D,) full initial/fixed parameter vector
    likelihood: str = "chi22p"
    sigma_spec: Optional[jnp.ndarray] = None   # for chi_square likelihood
    mask: Optional[jnp.ndarray] = None
    extra_logp: Optional[Callable] = None      # cross-parameter constraints
    model_meta: Optional[dict] = None          # {"name": family, "spec":
                                               # spec dataclass} — lets the
                                               # stacked ensemble PROVE two
                                               # stars share a model family
                                               # and rebuild merged-window
                                               # closures (ensemble.py)

    def __post_init__(self):
        assert self.priors.ndim == self.layout.ndim, \
            f"prior table has {self.priors.ndim} rows, layout {self.layout.ndim}"

    def astype(self, dtype):
        """Copy with data/parameter arrays cast to `dtype`.

        The f64 validation path (`tamcmc run --precision f64`, CPU
        enable_x64): the reference samples in double precision [U], and
        casting (nu, spec, params0, sigma, mask) to f64 makes every
        downstream sampler computation — model, likelihood, gradients,
        adaptation, Cholesky — run f64 via JAX type promotion (init_state
        derives all state dtypes from params0).  Model-closure constants
        captured at build time (window hints, quiet-bin partial sums) stay
        f32; they are walker-independent offsets that cancel in MH ratios."""
        def c(a):
            return None if a is None else jnp.asarray(a, dtype)
        return dataclasses.replace(
            self, nu=c(self.nu), spec=c(self.spec), params0=c(self.params0),
            sigma_spec=c(self.sigma_spec), mask=c(self.mask))

    # ---- data arrays as jit arguments ----
    def data(self) -> dict:
        """The grid-sized arrays (nu, spec, sigma_spec, mask) that are set.

        Jitted programs take these as ARGUMENTS (`with_data` inside the
        traced function) instead of closing over them: a closed-over array
        is a compile-time constant, XLA constant-folds the slices and
        fixed-parameter pieces derived from it into dozens of grid-sized
        constants, and the GPU backend embeds each in the generated code —
        compiles of the full-width models then ran for many minutes."""
        return {k: v for k, v in (("nu", self.nu), ("spec", self.spec),
                                  ("sigma_spec", self.sigma_spec),
                                  ("mask", self.mask)) if v is not None}

    def with_data(self, data: dict) -> "Problem":
        return dataclasses.replace(self, **data)

    # ---- free-subspace machinery (static) ----
    @property
    def free_idx(self) -> np.ndarray:
        return np.nonzero(self.priors.free_mask)[0]

    @property
    def ndim_free(self) -> int:
        return int(self.free_idx.shape[0])

    @property
    def free_names(self):
        # prefer user-facing names from the prior table (problem files set
        # them); fall back to the layout's block-derived names
        if self.priors.names and len(self.priors.names) == self.layout.ndim:
            names = list(self.priors.names)
        else:
            names = self.layout.param_names()
        return [names[i] for i in self.free_idx]

    @property
    def _embed_runs(self):
        """Static plan for embed: maximal runs of (is_free, full_lo, full_hi,
        free_lo).  Computed from the free mask at trace time — zero dynamic
        indexing inside jit."""
        free = np.zeros(self.layout.ndim, dtype=bool)
        free[self.free_idx] = True
        runs, i = [], 0
        D = free.shape[0]
        n_free_seen = 0
        while i < D:
            j = i
            while j < D and free[j] == free[i]:
                j += 1
            runs.append((bool(free[i]), i, j, n_free_seen))
            if free[i]:
                n_free_seen += j - i
            i = j
        return tuple(runs)

    def embed(self, x):
        """(..., Df) free vector -> (..., D) full params (fixed from params0).

        Built as a CONCAT of static runs, not a scatter into a broadcast
        base: fixed runs stay UNBATCHED constants under vmap, so every
        model subexpression that depends only on fixed parameters (e.g. the
        Harvey background when its A/B/p are frozen, which is the common
        production setup) is computed ONCE per step instead of once per
        (temperature, walker) — measured 1.5-2x step throughput on the
        config-3 bench (fixed-noise pow over the grid dominated the old
        profile, forward AND backward)."""
        pieces = []
        batch = x.shape[:-1]
        for is_free, lo, hi, flo in self._embed_runs:
            if is_free:
                pieces.append(x[..., flo:flo + (hi - lo)])
            else:
                const = self.params0[lo:hi]
                if batch:
                    const = jnp.broadcast_to(const, batch + const.shape)
                pieces.append(const)
        return jnp.concatenate(pieces, axis=-1)

    def extract(self, full):
        return full[..., jnp.asarray(self.free_idx)]

    # ---- log-posterior pieces ----
    @property
    def _pieces_hook(self):
        """Fused piece-wise chi22p path (window-partitioned models only):
        evaluate mode-sum pieces + background and reduce the likelihood per
        piece (stats/likelihoods.py likelihood_chi22p_pieces) instead of
        assembling the (batch, N) spectrum.  Semantically identical up to
        f32 reassociation; measured win: the concatenated spectrum is never
        written/re-read, and quiet-bin partial sums stay unbatched under
        vmap whenever the noise block is fully fixed."""
        # derive the chi22p check from the registry instead of duplicating
        # its alias list (a later alias would otherwise silently disable
        # this fused path — perf regression, not correctness)
        from tamcmc_tpu.stats.likelihoods import likelihood_chi22p
        try:
            is_chi22p = get_likelihood(self.likelihood) is likelihood_chi22p
        except KeyError:
            is_chi22p = False
        if is_chi22p and self.mask is None:
            return getattr(self.model_fn, "_segments_and_bg", None)
        return None

    def log_parts(self, x):
        """x: (Df,) free vector -> (logL, logP) scalars."""
        full = self.embed(x)
        logL = self._logL_from_full(full)
        logP = self.priors.log_prior(full)
        if self.extra_logp is not None:
            logP = logP + self.extra_logp(full)
        return logL, logP

    def _logL_from_full(self, full):
        hook = self._pieces_hook
        if hook is not None:
            from tamcmc_tpu.stats.likelihoods import likelihood_chi22p_pieces
            segs, bg = hook(full, self.nu)
            return likelihood_chi22p_pieces(self.spec, segs, bg)
        model = self.model_fn(full, self.nu)
        lfn = get_likelihood(self.likelihood)
        if self.likelihood == "chi_square":
            return lfn(self.spec, model, self.sigma_spec, self.mask)
        return lfn(self.spec, model, self.mask)

    def _logL_only(self, x):
        return self._logL_from_full(self.embed(x))

    def _logP_only(self, x):
        full = self.embed(x)
        logP = self.priors.log_prior(full)
        if self.extra_logp is not None:
            logP = logP + self.extra_logp(full)
        return logP

    def logparts_and_grad(self, x):
        """Values + grads of both log-posterior pieces.

        gradL and gradP must be stored SEPARATELY in the sampler state (the
        tempered drift is beta*gradL + gradP and beta re-binds on tempering
        swaps), but they need not share a backward pass: the prior piece
        never touches the model/grid, so its grad is a closed-form Df-sized
        computation, and the expensive model+likelihood graph is traversed
        backward exactly ONCE (a naive joint vjp paid two full model
        backward passes).
        Returns ((logL, logP), (gradL, gradP))."""
        logL, gradL = jax.value_and_grad(self._logL_only)(x)
        logP, gradP = jax.value_and_grad(self._logP_only)(x)
        return (logL, logP), (gradL, gradP)

    def batched_logparts_and_grad(self, x):
        """x: (T, C, Df) -> ((T,C), (T,C)), ((T,C,Df), (T,C,Df))."""
        f = jax.vmap(jax.vmap(self.logparts_and_grad))
        return f(x)

    def batched_log_parts(self, x):
        """Values only, no backward pass — the RW-Metropolis hot path
        (use_drift=False, the reference's default operating mode): the model
        graph is traversed FORWARD once, ~3x cheaper per step than the
        value+grad evaluation."""
        return jax.vmap(jax.vmap(self.log_parts))(x)
