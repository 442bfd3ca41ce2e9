"""Family prior assemblers: cross-parameter constraints per model family.

Reference equivalent: `priors_calc.cpp` — `priors_MS_Global`, `priors_local`,
`priors_asymptotic` [U] (SURVEY.md section 2 "Priors").  Besides the
per-parameter prior kinds (stats/priors.py), the reference's family
assemblers enforce *cross-parameter* physicality that no per-param table can
express: mode frequencies must stay ordered within each degree, the
inclination must stay in [0, pi/2], splittings/visibilities/widths must stay
positive.  Without these, a tempered walker can propose a frequency-crossed
state whose per-param priors are all individually satisfied — and the
posterior silently multi-modalises over permutations.

Design for XLA: each constraint is a pure `fn(full_params) -> scalar`
returning 0.0 when satisfied and NEG_BIG per violation (the same
finite -inf convention as the prior table, so autodiff through the MH accept
stays NaN-free; gradients of a violated hard constraint are zero and the
proposal is rejected with probability ~1).  `build_family_constraints`
composes the family's list at problem-build time and the result is installed
as `Problem.extra_logp` — evaluated inside the same jit region as the prior
table, at O(D) cost (negligible next to the grid eval).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from tamcmc_tpu.stats.priors import NEG_BIG
from tamcmc_tpu.utils.blocks import BlockLayout


def ordering(layout: BlockLayout, block: str) -> Callable:
    """Strictly-ascending constraint on a (possibly empty) block.

    The reference orders each degree's frequency list in the .model file and
    its assembler rejects proposals that cross neighbours [U]."""
    o, n = layout.offset(block), layout.size(block)

    def fn(p):
        if n < 2:
            return jnp.asarray(0.0, p.dtype)
        x = p[..., o:o + n]
        viol = jnp.sum((x[..., 1:] <= x[..., :-1]).astype(p.dtype), axis=-1)
        return NEG_BIG * viol

    return fn


def bounded(layout: BlockLayout, block: str, lo=None, hi=None,
            index: Optional[int] = None, count: Optional[int] = None):
    """Box constraint on a block (or an [index:index+count) sub-slice)."""
    o, n = layout.offset(block), layout.size(block)
    if index is not None:
        o += index
        n = count if count is not None else 1

    def fn(p):
        if n == 0:
            return jnp.asarray(0.0, p.dtype)
        x = p[..., o:o + n]
        viol = jnp.zeros((), p.dtype)
        if lo is not None:
            viol = viol + jnp.sum((x < lo).astype(p.dtype), axis=-1)
        if hi is not None:
            viol = viol + jnp.sum((x > hi).astype(p.dtype), axis=-1)
        return NEG_BIG * viol

    return fn


def compose(*fns) -> Optional[Callable]:
    """Sum of constraint terms; None for an empty list (no extra_logp)."""
    fns = [f for f in fns if f is not None]
    if not fns:
        return None

    def total(p):
        s = fns[0](p)
        for f in fns[1:]:
            s = s + f(p)
        # several simultaneous violations must not overflow f32
        return jnp.maximum(s, NEG_BIG)

    return total


def _freq_blocks(layout: BlockLayout):
    return [n for n in layout.names if n.startswith("freq_l")]


def _ms_global_constraints(layout: BlockLayout):
    """priors_MS_Global [U]: frequency ordering per degree, non-negative
    heights/widths/visibilities, inclination in [0, pi/2], a1 >= 0."""
    cons = [ordering(layout, b) for b in _freq_blocks(layout)]
    cons.append(bounded(layout, "heights", lo=0.0))
    if "widths" in layout.names:
        cons.append(bounded(layout, "widths", lo=0.0))
    cons.append(bounded(layout, "visibilities", lo=0.0))
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination",
                            lo=0.0, hi=float(jnp.pi / 2)))
    if "rot" in layout.names:
        # first rot entry is a1 (or the a1 table head for a1l/a1n/a1nl):
        # a solar-like envelope splitting is non-negative by construction
        cons.append(bounded(layout, "rot", lo=0.0, index=0))
    return cons


def _local_constraints(layout: BlockLayout):
    """priors_local [U]: same physicality set, per-window frequencies are
    free-ordered (windows don't overlap) so no ordering term."""
    cons = [bounded(layout, "heights", lo=0.0)]
    if "widths" in layout.names:
        cons.append(bounded(layout, "widths", lo=0.0))
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination",
                            lo=0.0, hi=float(jnp.pi / 2)))
    return cons


def _rgb_constraints(layout: BlockLayout):
    """priors_asymptotic [U]: p-mode ordering + positive period spacing and
    coupling (the ARMM solver's domain: DPi1 > 0, 0 < q)."""
    cons = [ordering(layout, b) for b in _freq_blocks(layout)]
    cons.append(bounded(layout, "heights", lo=0.0))
    if "widths" in layout.names:
        cons.append(bounded(layout, "widths", lo=0.0))
    if "mixed" in layout.names:
        cons.append(bounded(layout, "mixed", lo=1e-3, index=0))  # DPi1
        cons.append(bounded(layout, "mixed", lo=1e-4, index=2))  # q
    if "inclination" in layout.names:
        cons.append(bounded(layout, "inclination",
                            lo=0.0, hi=float(jnp.pi / 2)))
    return cons


def _ajfit_constraints(layout: BlockLayout):
    """ajfit [U]: ordered nuisance centroids (the fitted multiplets are a
    frequency-sorted table), physical activity block: epsilon >= 0,
    theta0 in [0, pi/2] (latitude), delta > 0."""
    cons = [ordering(layout, "nu_nl")]
    if "activity" in layout.names:
        cons.append(bounded(layout, "activity", lo=0.0, index=0))
        cons.append(bounded(layout, "activity", lo=0.0,
                            hi=float(jnp.pi / 2), index=1))
        cons.append(bounded(layout, "activity", lo=1e-3, index=2))
    return cons


def build_family_constraints(model_name: str,
                             layout: BlockLayout) -> Optional[Callable]:
    """The family assembler: model name -> composed extra_logp (or None).

    Families are matched on name prefixes, mirroring the reference's
    assembler dispatch (`priors_calc.cpp` [U])."""
    name = model_name.strip().lower()
    if name.startswith("model_ms_global"):
        return compose(*_ms_global_constraints(layout))
    if name.startswith("model_ms_local"):
        return compose(*_local_constraints(layout))
    if name.startswith("model_rgb_asympt"):
        return compose(*_rgb_constraints(layout))
    if name.startswith("model_ajfit"):
        return compose(*_ajfit_constraints(layout))
    return None  # test/background families: per-param priors suffice
