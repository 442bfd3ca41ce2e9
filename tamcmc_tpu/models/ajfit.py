"""ajfit — fit a-coefficients (+ Alm activity asphericity) to measured
per-(n, l, m) mode frequencies.

Reference equivalent: `io_ajfit.cpp` + `model_ajfit` [U] (SURVEY.md §1 L4
lists io_ajfit among the problem-setup readers).  Unlike the spectrum
families, the data here are a TABLE of individual azimuthal-component
centroid frequencies nu_nlm (typically the output of a prior local/global
peak-bagging posterior) with Gaussian uncertainties; the model predicts

    nu_nlm = nu_nl + sum_{j=1..6} a_j P_j^{(l)}(m)            (Ritzwoller &
                                                              Lavely 1991)
           + epsilon * nu_nl * A_lm(theta0, delta)            (optional Alm
                                                              activity term)

and the likelihood is the per-point-sigma Gaussian chi_square
(`stats/likelihoods.py`), NOT the spectral chi^2(2 d.o.f.).

Design for XLA: the (l, m) structure is fully static — multiplets are
grouped by degree at trace time, each group's prediction is one vectorised
`split_frequencies_aj` call, and the data vector is a flat static
concatenation (m = -l..l within each multiplet, multiplets in spec order).
There is no frequency grid; `nu` passed to model_fn is the data-point index
(ignored), so the whole sampler stack (Problem, MALA, tempering, sharding)
works unchanged with a D ~ tens parameter space and an O(n_points) model —
the step is trivially VPU-bound and dominated by the quadrature-free
activity shift when enabled.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from tamcmc_tpu.utils.blocks import BlockLayout
from tamcmc_tpu.ops.rotation import split_frequencies_aj
from tamcmc_tpu.ops.alm import alm_shifts


@dataclasses.dataclass(frozen=True)
class AjFitSpec:
    """l_per_multiplet: degree of each fitted multiplet (one nu_nl nuisance
    centroid per entry); data points are ALL 2l+1 m-components of each
    multiplet, flattened in order.  include_activity adds the
    (epsilon, theta0, delta) Alm asphericity block."""
    l_per_multiplet: tuple = (1, 1, 1, 2, 2, 2)
    include_activity: bool = True
    filter_kind: str = "gate"          # gate | triangle (ops/alm.py)

    def __post_init__(self):
        assert all(1 <= l <= 3 for l in self.l_per_multiplet), \
            "ajfit multiplets must have 1 <= l <= 3 (l=0 has no splitting)"

    @property
    def n_points(self) -> int:
        return sum(2 * l + 1 for l in self.l_per_multiplet)

    def layout(self):
        blocks = [("nu_nl", len(self.l_per_multiplet)), ("aj", 6)]
        if self.include_activity:
            blocks.append(("activity", 3))    # epsilon, theta0, delta [rad]
        return BlockLayout.make(blocks)

    def point_labels(self):
        """Flat (l, m) label per data point, in model-output order."""
        out = []
        for i, l in enumerate(self.l_per_multiplet):
            out += [(i, l, m) for m in range(-l, l + 1)]
        return out


def build_ajfit(spec: AjFitSpec):
    layout = spec.layout()
    ls = spec.l_per_multiplet
    # group multiplets by degree (static): one vectorised splitting call per
    # distinct l, then a static re-ordering back to spec order
    groups = {}
    for i, l in enumerate(ls):
        groups.setdefault(l, []).append(i)

    def model_fn(params, nu):
        del nu                                  # table fit: no grid
        nu_nl = layout.get(params, "nu_nl")     # (n_multiplets,)
        aj = layout.get(params, "aj")           # (6,)
        if spec.include_activity:
            act = layout.get(params, "activity")
            eps, th0 = act[..., 0], act[..., 1]
            delta = act[..., 2]
        segs = [None] * len(ls)
        for l, idxs in groups.items():
            nus = nu_nl[..., jnp.asarray(np.asarray(idxs))]   # (k,)
            pred = split_frequencies_aj(l, nus, aj)           # (k, 2l+1)
            if spec.include_activity:
                pred = pred + alm_shifts(l, nus, eps, th0, delta,
                                         kind=spec.filter_kind)
            for row, i in enumerate(idxs):
                segs[i] = pred[..., row, :]
        return jnp.concatenate(segs, axis=-1)   # (n_points,)

    return model_fn, layout
