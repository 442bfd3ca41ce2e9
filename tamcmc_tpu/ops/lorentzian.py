"""Lorentzian mode-profile builders — the hot kernel of the whole engine.

Reference equivalent: `build_lorentzian.cpp — optimum_lorentzian_calc_*` [U]
(SURVEY.md section 2).  The reference evaluates each Lorentzian only inside a
truncation window c*Gamma around its centre (data-dependent loop bounds).
Redesign for XLA: every azimuthal component is evaluated *densely* on the
full static frequency grid and all components are accumulated in one
contraction — no data-dependent shapes, fully fusable by XLA, batched over
(temperature, chain) by vmap.

Profile (with Nigam & Kosovichev 1998-style asymmetry `b`):
    x = 2 (nu - nu0) / Gamma
    L(nu) = H * [(1 + b*x)^2 + b^2] / (1 + x^2)
b = 0 recovers the symmetric Lorentzian H / (1 + x^2).

Performance design:

* **Factored algebra.** Expanding the numerator, (1+bx)^2 + b^2 =
  1 + 2bx + b^2(1 + x^2), so
      L = H b^2  +  (H + 2Hb·x) / (1 + x^2).
  The H b^2 term is frequency-independent — a per-component scalar folded
  into the accumulator once — and the remaining per-bin work is one
  multiply for x (2/Gamma precomputed per component), one fma for 1+x^2,
  one reciprocal, one fma, one accumulate.  This removes one full division
  and the squaring from the naive form.

* **No scan.** The (ncomp x N) broadcast is left to XLA as one fused
  loop+reduction; a `lax.scan` over component blocks (earlier design) paid
  HBM round-trips of the (N,) accumulator between steps.  A python-level
  chunk loop (unrolled, still fusable) bounds the intermediate size for
  very large component counts (RGB mixed-mode models).

* **Analytic custom VJP.** Naive autodiff of the accumulation saves
  gigabytes of residuals when batched over hundreds of walkers; the
  backward here is ONE fused pass computing closed-form cotangents with
  shared elementwise temps (u = g/v, p = x·u, q = p/v, r = x·q, s = x·r)
  and five reductions.  The grid `nu` is data, never a parameter: its
  cotangent is returned as zeros without computing the pass the old
  kernel wasted on it.
"""

import os

import jax
import jax.numpy as jnp

_CHUNK = 64   # components per unrolled chunk; bounds live (chunk, N) temps

_WFLOOR = 1e-6

# --- lever switches (A/B with tools/ab_step.py) ---
# TAMCMC_VJP_STORE_INV=1: save the forward's per-chunk inv=(1+x^2)^-1 as a
# VJP residual instead of recomputing it in the backward: the stored
# (comp, N)-batched residual costs a device-memory round trip (~2x 4B per
# comp-bin) where the recompute costs a few arithmetic ops per comp-bin.
_STORE_INV = os.environ.get("TAMCMC_VJP_STORE_INV", "") == "1"
# TAMCMC_LORENTZ_BF16=1 (or set_profile_precision("bf16")): do the
# per-(comp, bin) profile arithmetic in bfloat16 with f32 accumulation.
# x is computed in f32 FIRST (the grid offset nu - c needs ~1e-5 relative
# precision at uHz scales; bf16's 8-bit mantissa would quantise mode
# positions by ~0.4%) and only the inv/multiply stream is bf16.
# Posterior-validated vs f32 on BASELINE configs 1-3 with the parity
# harness (tools/validate_bf16.py); its speed on the GPU is not measured yet.
_BF16 = os.environ.get("TAMCMC_LORENTZ_BF16", "") == "1"
# set on the first trace of the profile kernels: compiled programs bake the
# precision in, so flipping it afterwards would silently mix precisions via
# stale jit caches (round-4 advisor, low) — set_profile_precision REFUSES
# a post-trace change instead.
_TRACED = False


def set_profile_precision(precision: str):
    """Select the Lorentzian profile-stream precision: "f32" (default) or
    "bf16" (~0.4%-quantised profile values, f32 accumulation,
    posterior-validated — the user-facing switch behind
    `tamcmc run --precision bf16`).

    Must be called before the first model build/trace; calling it after a
    profile kernel has traced with a DIFFERENT precision raises (stale jit
    caches would otherwise serve mixed-precision results).  Re-asserting
    the already-active precision is a no-op.
    """
    global _BF16
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', "
                         f"got {precision!r}")
    want = precision == "bf16"
    if _TRACED and want != _BF16:
        raise RuntimeError(
            f"set_profile_precision({precision!r}) called after a Lorentzian "
            "kernel already traced with "
            f"{'bf16' if _BF16 else 'f32'}: compiled programs bake the "
            "precision in and jit caches would serve stale mixed-precision "
            "results.  Set the precision before building any model (the CLI "
            "does this first thing in cmd_run), or clear jax caches and "
            "rebuild every model_fn.")
    _BF16 = want


def _reset_precision_guard():
    """Test hook: forget the traced-once latch (callers must also clear jax
    caches if they actually flip precision between fits in one process)."""
    global _TRACED
    _TRACED = False


def lorentzian_profile(nu, height, nu0, width, asym=0.0):
    """Single (possibly asymmetric) Lorentzian on grid `nu`.

    All of (height, nu0, width, asym) may broadcast; width is clamped to a
    small positive floor for differentiability safety.
    """
    w = jnp.maximum(width, _WFLOOR)
    x = 2.0 * (nu - nu0) / w
    num = (1.0 + asym * x) ** 2 + asym**2
    return height * num / (1.0 + x * x)


def _fwd_impl(nu, heights, nu0s, widths, asyms, keep_inv=False):
    global _TRACED
    _TRACED = True
    w = jnp.maximum(widths, _WFLOOR)
    iw = 2.0 / w
    hb2 = 2.0 * heights * asyms
    ncomp = heights.shape[0]
    # frequency-independent continuum of the asymmetric terms: sum_k H_k b_k^2
    out = jnp.broadcast_to(jnp.sum(heights * asyms * asyms), nu.shape)
    invs = []
    for s in range(0, ncomp, _CHUNK):
        e = min(s + _CHUNK, ncomp)
        x = (nu[None, :] - nu0s[s:e, None]) * iw[s:e, None]   # (chunk, N)
        if _BF16:
            # x stays f32 (position precision); the inv/product stream is
            # bf16; the cross-component accumulation is f32
            xb = x.astype(jnp.bfloat16)
            inv = jnp.bfloat16(1.0) / (jnp.bfloat16(1.0) + xb * xb)
            contrib = (heights[s:e, None].astype(jnp.bfloat16)
                       + hb2[s:e, None].astype(jnp.bfloat16) * xb) * inv
            out = out + jnp.sum(contrib, axis=0, dtype=jnp.float32)
        else:
            inv = 1.0 / (1.0 + x * x)
            out = out + jnp.sum(
                (heights[s:e, None] + hb2[s:e, None] * x) * inv, axis=0)
        if keep_inv:
            invs.append(inv)
    return (out, invs) if keep_inv else out


@jax.custom_vjp
def sum_lorentzians(nu, heights, nu0s, widths, asyms):
    """Accumulate ncomp Lorentzian components on the grid.

    nu: (N,); heights/nu0s/widths/asyms: (ncomp,) -> returns (N,).
    Dense masked evaluation: components with height == 0 contribute exactly 0
    (used for static padding of variable mode counts).
    """
    return _fwd_impl(nu, heights, nu0s, widths, asyms)


def _fwd(nu, heights, nu0s, widths, asyms):
    if _STORE_INV:
        out, invs = _fwd_impl(nu, heights, nu0s, widths, asyms, keep_inv=True)
        return out, (nu, heights, nu0s, widths, asyms, invs)
    return _fwd_impl(nu, heights, nu0s, widths, asyms), \
        (nu, heights, nu0s, widths, asyms, None)


def _bwd(res, g):
    """Closed-form cotangents of the factored form
        L = H b^2 + (H + 2Hb·x) * inv,   inv = 1/(1+x^2),  x = (nu-c)·(2/w):
      dL/dH = b^2 + (1 + 2bx)·inv
      dL/db = 2Hb + 2H·x·inv
      dL/dx = 2Hb·inv − (H + 2Hb·x)·2x·inv^2
      dx/dc = −2/w,  dx/dw = −x/w.
    G = Σ g is shared by every component's dL/dH, dL/db constant parts.
    """
    nu, heights, nu0s, widths, asyms, invs = res
    w = jnp.maximum(widths, _WFLOOR)
    iw = 2.0 / w
    G = jnp.sum(g)
    ncomp = heights.shape[0]
    ghs, gcs, gws, gbs = [], [], [], []
    for ci, sidx in enumerate(range(0, ncomp, _CHUNK)):
        e = min(sidx + _CHUNK, ncomp)
        hh = heights[sidx:e, None]
        bb = asyms[sidx:e, None]
        hb2 = 2.0 * hh * bb
        x = (nu[None, :] - nu0s[sidx:e, None]) * iw[sidx:e, None]
        if _BF16:
            # the whole backward stream runs in bf16 with f32 reductions:
            # gradient cotangents only shape the PROPOSAL (drift mean) —
            # the MH correction uses the same drift on both sides, so
            # detailed balance holds exactly regardless of gradient
            # precision; bf16 here costs mixing efficiency O(0.4%) and
            # zero posterior bias
            xb = x.astype(jnp.bfloat16)
            invb = jnp.bfloat16(1.0) / (jnp.bfloat16(1.0) + xb * xb)
            if invs is not None:
                invb = invs[ci].astype(jnp.bfloat16)
            ub = g[None, :].astype(jnp.bfloat16) * invb
            pb = xb * ub
            qb = pb * invb
            rb = xb * qb
            sb = xb * rb
            f32 = jnp.float32
            Su = jnp.sum(ub, axis=1, keepdims=True, dtype=f32)
            Sp = jnp.sum(pb, axis=1, keepdims=True, dtype=f32)
            Sq = jnp.sum(qb, axis=1, keepdims=True, dtype=f32)
            Sr = jnp.sum(rb, axis=1, keepdims=True, dtype=f32)
            Ss = jnp.sum(sb, axis=1, keepdims=True, dtype=f32)
        else:
            if invs is not None:
                inv = invs[ci].astype(x.dtype)  # stored residual (A/B b)
            else:
                inv = 1.0 / (1.0 + x * x)
            u = g[None, :] * inv
            p = x * u
            q = p * inv
            r = x * q
            s = x * r
            Su = jnp.sum(u, axis=1, keepdims=True)
            Sp = jnp.sum(p, axis=1, keepdims=True)
            Sq = jnp.sum(q, axis=1, keepdims=True)
            Sr = jnp.sum(r, axis=1, keepdims=True)
            Ss = jnp.sum(s, axis=1, keepdims=True)
        gh = bb * bb * G + Su + 2.0 * bb * Sp
        gb = hb2 * G + 2.0 * hh * Sp
        # Σ g·dL/dx and Σ g·x·dL/dx from the shared reductions
        dx = hb2 * Su - 2.0 * hh * Sq - 2.0 * hb2 * Sr
        dxx = hb2 * Sp - 2.0 * hh * Sr - 2.0 * hb2 * Ss
        gc = -iw[sidx:e, None] * dx
        gw = -dxx / w[sidx:e, None]
        ghs.append(gh[:, 0])
        gcs.append(gc[:, 0])
        gws.append(gw[:, 0])
        gbs.append(gb[:, 0])

    def cat(parts):
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts)

    # width clamp: no gradient where the clamp was active
    gw_all = jnp.where(widths > _WFLOOR, cat(gws), 0.0)
    return (jnp.zeros_like(nu), cat(ghs), cat(gcs), gw_all, cat(gbs))


sum_lorentzians.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# Truncated-window variant — the reference's actual model definition
# ---------------------------------------------------------------------------
#
# The reference evaluates each Lorentzian ONLY inside |nu - nu0| <= trunc *
# Gamma (`optimum_lorentzian_calc_*` [U]); bins outside the window get
# exactly zero.  This variant reproduces those semantics with static shapes:
# a per-bin mask (never a dynamic slice), so XLA sees dense shapes while the
# model matches the reference's truncation behaviour bit-for-bit in spirit.
# `windows` is the per-component HALF-width (trunc * Gamma); pass +inf for
# dense (untruncated) evaluation.
#
# Shape-generic over leading batch dims: params (..., NC), nu (N,) ->
# (..., N).

def _trunc_fwd_impl(nu, heights, nu0s, widths, asyms, windows):
    w = jnp.maximum(widths, _WFLOOR)
    iw = 2.0 / w
    hb2 = 2.0 * heights * asyms
    hbb = heights * asyms * asyms
    ncomp = heights.shape[-1]
    lead = heights.shape[:-1]
    out = jnp.zeros(lead + nu.shape, dtype=nu.dtype)
    for s in range(0, ncomp, _CHUNK):
        e = min(s + _CHUNK, ncomp)
        c = nu0s[..., s:e, None]
        x = (nu - c) * iw[..., s:e, None]              # (..., chunk, N)
        m = (jnp.abs(nu - c) <= windows[..., s:e, None]).astype(nu.dtype)
        inv = 1.0 / (1.0 + x * x)
        contrib = hbb[..., s:e, None] \
            + (heights[..., s:e, None] + hb2[..., s:e, None] * x) * inv
        out = out + jnp.sum(contrib * m, axis=-2)
    return out


@jax.custom_vjp
def sum_lorentzians_trunc(nu, heights, nu0s, widths, asyms, windows):
    """Windowed Lorentzian accumulation (reference truncation semantics).

    nu: (N,); heights/nu0s/widths/asyms/windows: (..., NC) -> (..., N).
    A component contributes 0 outside |nu - nu0| <= window; window = +inf
    recovers the dense profile.  Zero-height components contribute 0.
    """
    return _trunc_fwd_impl(nu, heights, nu0s, widths, asyms, windows)


def _trunc_fwd(nu, heights, nu0s, widths, asyms, windows):
    return _trunc_fwd_impl(nu, heights, nu0s, widths, asyms, windows), \
        (nu, heights, nu0s, widths, asyms, windows)


def _trunc_bwd(res, g):
    """Same closed forms as _bwd, with every reduction masked by the window.
    The window itself gets no gradient (hard edges, like the reference)."""
    nu, heights, nu0s, widths, asyms, windows = res
    w = jnp.maximum(widths, _WFLOOR)
    iw = 2.0 / w
    ncomp = heights.shape[-1]
    ghs, gcs, gws, gbs = [], [], [], []
    for sidx in range(0, ncomp, _CHUNK):
        e = sidx + min(_CHUNK, ncomp - sidx)
        hh = heights[..., sidx:e, None]
        bb = asyms[..., sidx:e, None]
        hb2 = 2.0 * hh * bb
        c = nu0s[..., sidx:e, None]
        x = (nu - c) * iw[..., sidx:e, None]
        m = (jnp.abs(nu - c) <= windows[..., sidx:e, None]).astype(nu.dtype)
        inv = 1.0 / (1.0 + x * x)
        u = (g[..., None, :] * m) * inv
        p = x * u
        q = p * inv
        r = x * q
        s = x * r
        Gk = jnp.sum(g[..., None, :] * m, axis=-1)     # masked sum of g
        Su = jnp.sum(u, axis=-1)
        Sp = jnp.sum(p, axis=-1)
        Sq = jnp.sum(q, axis=-1)
        Sr = jnp.sum(r, axis=-1)
        Ss = jnp.sum(s, axis=-1)
        h2 = hh[..., 0]
        b2 = bb[..., 0]
        hb2s = hb2[..., 0]
        gh = b2 * b2 * Gk + Su + 2.0 * b2 * Sp
        gb = hb2s * Gk + 2.0 * h2 * Sp
        dx = hb2s * Su - 2.0 * h2 * Sq - 2.0 * hb2s * Sr
        dxx = hb2s * Sp - 2.0 * h2 * Sr - 2.0 * hb2s * Ss
        gc = -iw[..., sidx:e] * dx
        gw = -dxx / w[..., sidx:e]
        ghs.append(gh)
        gcs.append(gc)
        gws.append(gw)
        gbs.append(gb)

    def cat(parts):
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=-1)

    gw_all = jnp.where(widths > _WFLOOR, cat(gws), 0.0)
    return (jnp.zeros_like(nu), cat(ghs), cat(gcs), gw_all, cat(gbs),
            jnp.zeros_like(windows))


sum_lorentzians_trunc.defvjp(_trunc_fwd, _trunc_bwd)


# ---------------------------------------------------------------------------
# Static-window grouped accumulation — the reference's truncation ALGORITHM
# (skip the work, not just the value) with static shapes
# ---------------------------------------------------------------------------
#
# The masked variant above reproduces the reference's truncation *semantics*
# but still evaluates every (component, bin) pair — the mask costs what it
# saves.  This variant skips the arithmetic: component windows are resolved
# to STATIC grid slices at trace time (anchored at the problem's initial
# parameters, padded by a wander margin that dominates any plausible
# posterior drift), components are grouped by proximity, and each group
# evaluates densely only on its slice and adds into the accumulator with a
# static-offset update.  For a config-3 peak-bagging grid this cuts the
# (component x bin) work ~5-10x; windows are where the reference spends
# `optimum_lorentzian_calc_*`'s effort too [U], so perf parity is
# like-for-like.  Gradients flow through the per-group custom VJP.

def make_static_window_groups(centers, halfwidths, nu_start, nu_step,
                              n_bins, group_size: int = None,
                              new_group_cost_bins: int = None):
    """Host-side: static component groups for sum_lorentzians_grouped.

    centers/halfwidths: numpy (ncomp,) — TRACE-TIME estimates (from params0);
    halfwidth should include the truncation window c*Gamma plus a wander
    margin covering the prior's plausible drift.  Returns a tuple of
    (component_index_tuple, bin_lo, bin_hi) groups covering every component
    exactly once (components whose window misses the grid get an empty
    slice and contribute zero, like reference truncation).

    Grouping is COST-AWARE by default: walking the centers in sorted order,
    a component joins the current group only if that costs fewer
    (component x bin) evaluations than opening a new group — i.e.
    (n+1) * union_bins vs n * current_bins + own_bins + new_group_cost_bins.
    A group becomes its own kernels (forward, backward, likelihood piece)
    with their launches and their compile time, so by default a new group
    costs as much as one more component over the whole grid
    (new_group_cost_bins = n_bins).  On config 4 (120,000 bins) that gives
    ~10 segments instead of the ~200 a fixed 512-bin charge gave: the GPU
    compile of ~200 segments ran past 15 minutes.  Pass `group_size` for
    the legacy fixed-stride behaviour (kept for A/Bs); either way groups
    never exceed the kernel's unroll chunk.
    """
    import numpy as np
    centers = np.asarray(centers, dtype=np.float64)
    halfwidths = np.asarray(halfwidths, dtype=np.float64)
    order = np.argsort(centers)
    if new_group_cost_bins is None:
        new_group_cost_bins = n_bins

    def _bins(lo_f, hi_f):
        lo = int(np.clip(np.floor((lo_f - nu_start) / nu_step), 0, n_bins))
        hi = int(np.clip(np.ceil((hi_f - nu_start) / nu_step) + 1, 0, n_bins))
        return lo, max(hi, lo)

    groups = []
    if group_size is not None:                      # legacy fixed stride
        for s in range(0, order.shape[0], group_size):
            idx = order[s:s + group_size]
            hw = halfwidths[idx].max()
            lo, hi = _bins(centers[idx].min() - hw, centers[idx].max() + hw)
            groups.append((tuple(int(i) for i in idx), lo, hi))
        return tuple(groups)

    cur, cur_lo, cur_hi = [], 0.0, 0.0              # frequency-space union
    for i in order:
        c, hw = float(centers[i]), float(halfwidths[i])
        lo_f, hi_f = c - hw, c + hw
        if not cur:
            cur, cur_lo, cur_hi = [int(i)], lo_f, hi_f
            continue
        u_lo, u_hi = min(cur_lo, lo_f), max(cur_hi, hi_f)
        n = len(cur)
        cost_extend = (n + 1) * (u_hi - u_lo) / nu_step
        cost_split = (n * (cur_hi - cur_lo) + (hi_f - lo_f)) / nu_step \
            + new_group_cost_bins
        if cost_extend <= cost_split and n < _CHUNK:
            cur.append(int(i))
            cur_lo, cur_hi = u_lo, u_hi
        else:
            groups.append((tuple(cur),) + _bins(cur_lo, cur_hi))
            cur, cur_lo, cur_hi = [int(i)], lo_f, hi_f
    if cur:
        groups.append((tuple(cur),) + _bins(cur_lo, cur_hi))
    return tuple(groups)


def sum_lorentzians_grouped(nu, heights, nu0s, widths, asyms, groups):
    """Accumulate components over their static window groups.

    Semantics match sum_lorentzians_trunc with window = the group slice
    (zero outside — reference truncation); inside a slice the factored dense
    kernel (custom VJP) does the work.  `groups` must come from
    make_static_window_groups (static python data, part of the trace).

    NOTE (perf): the per-group `at[].add` chain below is fine in a
    standalone jit, but inside a `lax.scan` body XLA fails to alias the
    dynamic-update-slices in place and each group update copies the FULL
    (batch, N) accumulator, which multiplied the in-scan forward cost
    several times over.  The hot path therefore uses partition_window_groups +
    sum_lorentzians_segments (disjoint slices, output built by ONE concat —
    no scatter at all); this function remains the overlap-tolerant
    reference implementation for tests and A/Bs.
    """
    out = jnp.zeros(nu.shape, dtype=nu.dtype)
    for idx, lo, hi in groups:
        if hi <= lo:
            continue
        ii = jnp.asarray(idx)
        seg = sum_lorentzians(nu[lo:hi], heights[ii], nu0s[ii],
                              widths[ii], asyms[ii])
        out = out.at[lo:hi].add(seg)
    return out


def partition_window_groups(groups):
    """Resolve (possibly overlapping) window groups into DISJOINT segments
    (host-side, static) with BIT-IDENTICAL semantics and comp-bin cost.

    Input/output format matches make_static_window_groups: a tuple of
    (component_index_tuple, bin_lo, bin_hi).  The union of group ranges is
    cut at every group boundary into elementary intervals; each interval
    carries the union of the components of every group covering it, and
    adjacent intervals with identical component sets are re-merged.  A bin
    therefore receives exactly the same per-component contributions as in
    the grouped form (each component is evaluated on its own group's range,
    no more, no less), and the total (component x bin) work is unchanged —
    but the segments are disjoint, which lets sum_lorentzians_segments
    build its output by concatenation instead of the scatter-add chain
    (see that function's perf note).  Empty groups (hi <= lo: off-grid
    components) contribute exactly zero in both forms and are dropped."""
    live = [(tuple(idx), lo, hi) for idx, lo, hi in groups if hi > lo]
    if not live:
        return ()
    cuts = sorted({b for _, lo, hi in live for b in (lo, hi)})
    segs = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        comps = tuple(sorted({i for idx, glo, ghi in live
                              if glo < hi and ghi > lo for i in idx}))
        if not comps:
            continue
        if segs and segs[-1][0] == comps and segs[-1][2] == lo:
            segs[-1] = (comps, segs[-1][1], hi)
        else:
            segs.append((comps, lo, hi))
    return tuple(segs)


def sum_lorentzians_segments(nu, heights, nu0s, widths, asyms, segments):
    """Windowed accumulation over DISJOINT static segments, output built by
    one concatenation — the hot-path form of sum_lorentzians_grouped.

    `segments` must be disjoint and sorted (partition_window_groups).
    Inside a `lax.scan` body this writes each (batch, seg_bins) piece into
    the output exactly once; the grouped at[].add chain instead copies the
    full accumulator per group (XLA in-place aliasing fails across
    dynamic-update-slice chains in while-loop bodies).  Zero-filled gaps
    are unbatched constants under vmap."""
    N = nu.shape[0]
    pieces, pos = [], 0
    for lo, hi, seg in segment_values(nu, heights, nu0s, widths, asyms,
                                      segments):
        if lo > pos:
            pieces.append(jnp.zeros((lo - pos,), nu.dtype))
        pieces.append(seg)
        pos = hi
    if pos < N:
        pieces.append(jnp.zeros((N - pos,), nu.dtype))
    if not pieces:
        return jnp.zeros(nu.shape, dtype=nu.dtype)
    return pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces)


def segment_values(nu, heights, nu0s, widths, asyms, segments):
    """Evaluate each disjoint segment's mode sum: [(lo, hi, values)].

    The piece list feeds either sum_lorentzians_segments (full-spectrum
    assembly) or likelihood_chi22p_pieces (fused piece-wise likelihood that
    never materialises the concatenated spectrum)."""
    out = []
    for idx, lo, hi in segments:
        if hi <= lo:
            continue
        ii = jnp.asarray(idx)
        out.append((lo, hi, sum_lorentzians(nu[lo:hi], heights[ii], nu0s[ii],
                                            widths[ii], asyms[ii])))
    return out
