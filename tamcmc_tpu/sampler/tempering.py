"""Parallel tempering: geometric ladder + adjacent-pair swap moves.

Reference equivalent: `MALA::parallel_tempering` (`MALA.cpp` [U]; SURVEY.md
sections 2, 3.5): every dN_mixing iterations propose adjacent-pair swaps,
accept with min(1, exp[(beta_i - beta_j)(logL_j - logL_i)]).

Redesign for XLA: all rungs live on a leading T axis; a swap event applies
an even/odd-parity sweep of ALL adjacent pairs at once (deterministic
alternation — a superset of the reference's one-pair-per-event policy with
identical invariant distribution).  Swaps are static-partner gathers along T,
so on a sharded mesh they lower to `ppermute` neighbour exchanges (see
parallel/sharded.py).  Adaptation stats (mu/Sigma/sigma) do NOT travel:
they belong to the temperature rung.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tamcmc_tpu.sampler.state import SamplerState


def make_beta_ladder(n_temps: int, lambda_temp: float):
    """beta_k = 1 / T_k with the geometric ladder T_k = lambda^k, k=0..T-1.
    beta[0] = 1 is the cold (posterior) rung."""
    T = lambda_temp ** np.arange(n_temps)
    return jnp.asarray(1.0 / T, dtype=jnp.float32)


def _partners(n_temps: int, parity: int) -> np.ndarray:
    """Static partner index per rung for an even(0)/odd(1) parity sweep."""
    p = np.arange(n_temps)
    for i in range(parity, n_temps - 1, 2):
        p[i], p[i + 1] = i + 1, i
    return p


def tempering_swap(betas, state: SamplerState, key, parity, u=None):
    """One parity sweep of adjacent-pair swaps, batched over walkers.

    parity: traced int32 (0/1) — both partner tables are baked in and
    selected with `where`, keeping the step jit-static.
    u: optional (T, C) uniforms supplied by the caller (the shard_map
    runner's mesh-invariant draw protocol) instead of drawing from `key`.
    """
    T, C, _ = state.theta.shape
    if T < 2:
        return state
    part0 = jnp.asarray(_partners(T, 0))
    part1 = jnp.asarray(_partners(T, 1))
    partner = jnp.where(parity == 0, part0, part1)          # (T,)

    logL_p = state.logL[partner]                            # (T, C)
    # pair acceptance: Delta = (beta_lo - beta_hi)(logL_hi - logL_lo);
    # computed symmetrically — same value seen from both members of a pair.
    delta = (betas[:, None] - betas[partner][:, None]) * (logL_p - state.logL)
    if u is None:
        u = jax.random.uniform(key, (T, C))
    # share one uniform per pair: take the value from the lower rung index
    low = jnp.minimum(jnp.arange(T), partner)
    u_pair = u[low]
    is_paired = partner != jnp.arange(T)
    accept = (jnp.log(u_pair + 1e-38) < delta) & is_paired[:, None]  # (T, C)
    acc3 = accept[..., None]

    def swapped(x, acc):
        return jnp.where(acc, x[partner], x)

    new_state = state.replace(
        theta=swapped(state.theta, acc3),
        logL=swapped(state.logL, accept),
        logP=swapped(state.logP, accept),
        gradL=swapped(state.gradL, acc3),
        gradP=swapped(state.gradP, acc3),
    )
    # bookkeeping per pair (indexed by the lower rung)
    is_low = (partner == jnp.arange(T) + 1)
    att = is_low.astype(state.nswap_att.dtype)
    accf = jnp.mean(accept.astype(state.nswap_acc.dtype), axis=1) * att
    return new_state.replace(nswap_att=state.nswap_att + att,
                             nswap_acc=state.nswap_acc + accf)
