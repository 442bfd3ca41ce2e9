"""MS Global model family — the flagship "peak bagging" models.

Reference equivalents (`models.cpp` [U]; SURVEY.md section 2):
  model_MS_Global_a1etaa3_HarveyLike   -> "MS_Global_a1etaa3_HarveyLike"
  model_MS_Global_a1etaa3_HarveyLike_Classic (same math here)
  model_MS_Global_aj_HarveyLike        -> "MS_Global_aj_HarveyLike"

Block ABI (BlockLayout; order mirrors the reference's plength blocks [U]):
  heights   (N0,)       mode heights at the l=0 frequencies [ppm^2/uHz]
  visibilities (lmax,)  V^2 for l=1..lmax
  freq_l0..freq_l3      per-l mode frequencies [uHz] (size 0 blocks allowed)
  rot                   a1etaa3: [a1, eta0_switch, a3, asym]
                        aj:      [a1..a6, eta0_switch, asym]
  widths    (N0,)       mode widths at the l=0 frequencies [uHz]
  noise     (3*nh+1,)   Harvey components + white noise
  inclination (1,)      stellar inclination [rad internally; deg at IO edge]
  trunc     (1,)        reference's Lorentzian truncation parameter c —
                        ABI-only here (dense evaluation has no windows)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from tamcmc_tpu.utils.blocks import BlockLayout
from tamcmc_tpu.utils.constants import eta0_from_dnu, G_CGS, RHO_SUN, DNU_SUN
from tamcmc_tpu.ops.lorentzian import sum_lorentzians
from tamcmc_tpu.ops.noise import noise_background
from tamcmc_tpu.models.common import (
    assemble_components_a1etaa3, assemble_components_a1x,
    assemble_components_aj, assemble_components_ajAlm, dnu_from_freqs,
)
import math


@dataclasses.dataclass(frozen=True)
class MSGlobalSpec:
    """Static structure of an MS-Global problem (fixes all shapes)."""
    n_per_l: tuple          # e.g. (13, 13, 13, 0) — mode counts for l=0..3
    n_harvey: int = 3
    rotation: str = "a1etaa3"   # a1etaa3 | a1a2a3 | a1l | a1n | a1nl | aj | ajAlm
    alm_filter: str = "gate"    # activity filter for ajAlm ("gate"/"triangle")
    noise_kind: str = "harvey_like"   # or "harvey_1985"
    width_kind: str = "free"    # "free" (N0 per-mode widths) or "app2016"
                                # (6-param Appourchaux+2016 relation; see
                                # ops.widths — AppWidth reference families)
    window_hint: tuple = None   # optional static-truncation hint
                                # (params0_tuple, nu_start, nu_step, n_bins,
                                # margin_uHz): switches the Lorentzian
                                # accumulation to static window groups
                                # anchored at params0 — the reference's
                                # c*Gamma truncation ALGORITHM (skip the
                                # work), ~5-10x less (comp x bin) arithmetic
                                # on config-3 grids.  None = dense masked.
                                # params0_tuple may be a TUPLE OF TUPLES
                                # (one params0 per star): windows become the
                                # per-component UNION across stars — one
                                # shared closure that is conservative (hence
                                # correct) for every star of an aligned-grid
                                # ensemble (sampler/ensemble.py).

    @property
    def lmax(self):
        return max(l for l, n in enumerate(self.n_per_l) if n > 0 or l == 0)

    def rot_size(self) -> int:
        # rot block ABI per rotation law (reference model families [U]):
        #  a1etaa3 -> [a1, eta_sw, a3, asym]
        #  a1a2a3  -> [a1, a2, a3, asym]  (a2 fitted directly, no eta term)
        #  a1l     -> [a1_l1, a1_l2, eta_sw, a3, asym]  (l=3 uses the mean)
        #  a1n     -> [a1_0..a1_{N0-1}, eta_sw, a3, asym]
        #  a1nl    -> [a1l1_0.., a1l2_0.., eta_sw, a3, asym]
        #  aj      -> [a1..a6, eta_sw, asym]
        #  ajAlm   -> [a1, a3, a5, eta_sw, eps, theta0, delta, asym]
        n0 = self.n_per_l[0]
        return {"a1etaa3": 4, "a1a2a3": 4, "a1l": 5, "a1n": n0 + 3,
                "a1nl": 2 * n0 + 3, "aj": 8, "ajAlm": 8}[self.rotation]

    def width_size(self) -> int:
        # "free": one width per l=0 mode; "app2016": [numax, alpha,
        # Gamma_alpha, dGamma_dip, nu_dip, W_dip]
        return self.n_per_l[0] if self.width_kind == "free" else 6

    def layout(self) -> BlockLayout:
        rot_size = self.rot_size()
        spec = [("heights", self.n_per_l[0]),
                ("visibilities", max(self.lmax, 1) if self.lmax >= 1 else 0)]
        for l in range(4):
            spec.append((f"freq_l{l}",
                         self.n_per_l[l] if l < len(self.n_per_l) else 0))
        spec += [("rot", rot_size),
                 ("widths", self.width_size()),
                 ("noise", 3 * self.n_harvey + 1),
                 ("inclination", 1),
                 ("trunc", 1)]
        return BlockLayout.make(spec)


def _eta0_ingraph(f0, switch):
    """eta0 [s^2] from the in-graph Dnu scaling when switch > 0.5, else 0.
    eta0 = 3*pi/(G * rho_sun * (Dnu/Dnu_sun)^2)."""
    dnu = dnu_from_freqs(f0)
    eta0 = 3.0 * math.pi / (G_CGS * RHO_SUN) * (DNU_SUN / dnu) ** 2
    return jnp.where(switch > 0.5, eta0, 0.0)


def build_ms_global(spec: MSGlobalSpec):
    """Return (model_fn, layout): model_fn(params, nu) -> spectrum (N,)."""
    layout = spec.layout()
    n_per_l = tuple(spec.n_per_l) + (0,) * (4 - len(spec.n_per_l))

    def assemble(params):
        heights = layout.get(params, "heights")
        widths = layout.get(params, "widths")
        if spec.width_kind == "app2016":
            # widths block is the 6-param Appourchaux+2016 relation; expand
            # to per-mode widths on the l=0 ridge (l>0 widths then come from
            # the usual interpolation, exact for this smooth relation)
            from tamcmc_tpu.ops.widths import appourchaux2016_width
            f0_w = layout.get(params, "freq_l0")
            widths = appourchaux2016_width(
                f0_w, widths[..., 0], widths[..., 1], widths[..., 2],
                widths[..., 3], widths[..., 4], widths[..., 5])
        vis = layout.get(params, "visibilities")
        # always 4 entries (size-0 arrays for absent degrees) so the list
        # index IS the degree — assemblers skip empties
        freqs_per_l = [layout.get(params, f"freq_l{l}") for l in range(4)]
        rot = layout.get(params, "rot")
        noise = layout.get(params, "noise")
        inc = layout.get(params, "inclination")[..., 0]

        if spec.rotation == "a1etaa3":
            a1, sw, a3, asym = rot[..., 0], rot[..., 1], rot[..., 2], rot[..., 3]
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_a1etaa3(
                freqs_per_l, heights, widths, vis, inc, a1, eta0, a3, asym)
        elif spec.rotation == "a1a2a3":
            # a2 fitted directly (no centrifugal eta term): nu_nlm = nu +
            # a1 P1(m) + a2 P2(m) + a3 P3(m)  (model_MS_Global_a1a2a3_* [U])
            a1, a2, a3, asym = (rot[..., i] for i in range(4))
            zeros = jnp.zeros_like(a1)
            aj6 = jnp.stack([a1, a2, a3, zeros, zeros, zeros], axis=-1)
            H, C, W, B = assemble_components_aj(
                freqs_per_l, heights, widths, vis, inc, aj6,
                jnp.zeros_like(a1), asym)
        elif spec.rotation in ("a1l", "a1n", "a1nl"):
            n0 = n_per_l[0]
            if spec.rotation == "a1l":
                a1_1, a1_2 = rot[..., 0], rot[..., 1]
                sw, a3, asym = rot[..., 2], rot[..., 3], rot[..., 4]
                # l=0 unused (no splitting); l=3 convention: mean of l=1,2 [U]
                a1_per_l = [a1_1, a1_1, a1_2, 0.5 * (a1_1 + a1_2)]
            elif spec.rotation == "a1n":
                a1n = rot[..., 0:n0]
                sw, a3, asym = rot[..., n0], rot[..., n0 + 1], rot[..., n0 + 2]
                a1_per_l = [a1n[..., :n_per_l[l]] for l in range(4)]
            else:  # a1nl: separate per-order tables for l=1 and l=2
                a1n1 = rot[..., 0:n0]
                a1n2 = rot[..., n0:2 * n0]
                sw, a3, asym = (rot[..., 2 * n0], rot[..., 2 * n0 + 1],
                                rot[..., 2 * n0 + 2])
                a1m = 0.5 * (a1n1 + a1n2)
                a1_per_l = [a1n1[..., :n_per_l[0]], a1n1[..., :n_per_l[1]],
                            a1n2[..., :n_per_l[2]], a1m[..., :n_per_l[3]]]
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_a1x(
                freqs_per_l, heights, widths, vis, inc, a1_per_l,
                eta0, a3, asym)
        elif spec.rotation == "ajAlm":
            a1, a3, a5, sw = (rot[..., i] for i in range(4))
            epsilon, theta0, delta, asym = (rot[..., i] for i in range(4, 8))
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_ajAlm(
                freqs_per_l, heights, widths, vis, inc, a1, a3, a5, eta0,
                epsilon, theta0, delta, asym, filter_kind=spec.alm_filter)
        else:
            aj = rot[..., 0:6]
            sw, asym = rot[..., 6], rot[..., 7]
            eta0 = _eta0_ingraph(freqs_per_l[0], sw)
            H, C, W, B = assemble_components_aj(
                freqs_per_l, heights, widths, vis, inc, aj, eta0, asym)
        return H, C, W, B, noise

    groups = None
    if spec.window_hint is not None:
        # resolve static truncation windows ONCE at build time from the
        # initial parameter vector(s) (margin covers posterior wander)
        import numpy as np
        import jax
        from tamcmc_tpu.ops.lorentzian import make_static_window_groups
        p0_t, nu_start, nu_step, n_bins, margin = spec.window_hint
        stars = (p0_t if p0_t and isinstance(p0_t[0], (tuple, list))
                 else (p0_t,))
        # one small jitted call per star on the host CPU (set-up work, the
        # same windows on every backend); eager assembly would dispatch
        # dozens of tiny ops one by one
        try:
            cpu = jax.local_devices(backend="cpu")[0]
        except RuntimeError:
            cpu = None
        import contextlib
        ctx = jax.default_device(cpu) if cpu else contextlib.nullcontext()
        lo = hi = None
        with ctx:
            a_jit = jax.jit(assemble)
            for star_p0 in stars:
                p0 = jnp.asarray(np.asarray(star_p0, dtype=np.float32))
                H0, C0, W0, B0, _ = a_jit(p0)
                trunc0 = float(np.asarray(layout.get(p0, "trunc"))[0]) or 40.0
                hw = trunc0 * np.maximum(np.asarray(W0), 1e-3) + float(margin)
                C0 = np.asarray(C0)
                # per-component union across stars: conservative windows that
                # cover every star's modes, so ONE closure serves the whole
                # aligned-grid ensemble
                lo = C0 - hw if lo is None else np.minimum(lo, C0 - hw)
                hi = C0 + hw if hi is None else np.maximum(hi, C0 + hw)
        from tamcmc_tpu.ops.lorentzian import partition_window_groups
        groups = partition_window_groups(make_static_window_groups(
            0.5 * (lo + hi), 0.5 * (hi - lo), nu_start, nu_step, int(n_bins)))

    def model_fn(params, nu):
        H, C, W, B, noise = assemble(params)
        if groups is not None:
            from tamcmc_tpu.ops.lorentzian import sum_lorentzians_segments
            modes = sum_lorentzians_segments(nu, H, C, W, B, groups)
        else:
            modes = sum_lorentzians(nu, H, C, W, B)
        bg = noise_background(nu, noise, n_harvey=spec.n_harvey,
                              kind=spec.noise_kind)
        return modes + bg

    model_fn._window_groups = groups   # introspection (bench FLOP model)
    if groups is not None:
        from tamcmc_tpu.ops.lorentzian import segment_values

        def segments_and_bg(params, nu):
            """Hot-path hook (sampler/problem.py): the window partition's
            piece values + a per-piece background evaluator, WITHOUT
            assembling the full spectrum — feeds likelihood_chi22p_pieces,
            which skips the (batch, N) concat and keeps quiet-bin work
            unbatched when noise is fixed.  The background is evaluated per
            piece (see the likelihood's docstring for why a sliced
            full-grid background would poison the backward pass)."""
            H, C, W, B, noise = assemble(params)

            def bg_fn(lo, hi):
                return noise_background(nu[lo:hi], noise,
                                        n_harvey=spec.n_harvey,
                                        kind=spec.noise_kind)

            return segment_values(nu, H, C, W, B, groups), bg_fn

        model_fn._segments_and_bg = segments_and_bg
    return model_fn, layout
