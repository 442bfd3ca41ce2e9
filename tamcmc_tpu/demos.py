"""Built-in demo problems — the BASELINE.json config ladder.

Each demo builds a synthetic problem whose data are generated FROM the model
itself (chi^2 2-d.o.f. multiplicative noise for raw periodograms), so
posterior recovery of the injected truth validates the whole pipeline —
the validation style of the reference's shipped example setups
(SURVEY.md section 4).

  single_lorentzian  — BASELINE config 1 (CPU-runnable smoke)
  harvey_background  — config 2 (smoothed spectrum, Gaussian likelihood)
  ms_global          — config 3 (l=0,1,2 with a1 + inclination)
  kepler_full        — config 4 (dozens of modes, 10+ temperatures)
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tamcmc_tpu.models import build_model
from tamcmc_tpu.models.ms_global import MSGlobalSpec
from tamcmc_tpu.stats.priors import PriorTable
from tamcmc_tpu.sampler.problem import Problem
from tamcmc_tpu.sampler.state import MALAHyper
from tamcmc_tpu.sampler.driver import PhasePlan


def _chi2_noise(key, model):
    return model * jax.random.exponential(key, model.shape)


def _make_synthetic(fn, truth, nu, key):
    """model eval + chi2(2dof) noise in ONE jit call on the host CPU device.
    Data generation is a one-shot set-up task, and generating on the host
    gives every backend the same synthetic spectrum bit for bit, so a fit on
    the GPU targets exactly the data its CPU references saw.  The result is
    handed back UNCOMMITTED on the default device: a CPU-committed spectrum
    would pull every jitted computation that closes over it onto the host."""
    try:
        # local_devices, NOT devices: in a multi-process run the first
        # global CPU device may belong to another process, and committing
        # data there makes every downstream eager op fail with
        # "not fully addressable"
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        cpu = None

    @jax.jit
    def gen(t, n, k):
        m = fn(t, n)
        return m, _chi2_noise(k, m)

    if cpu is None:
        return gen(truth, nu, key)
    with jax.default_device(cpu):
        m, s = gen(truth, nu, key)
    return jnp.asarray(np.asarray(m)), jnp.asarray(np.asarray(s))


def make_demo(name: str, seed: int = 0, ngrid: int = None,
              n_orders: int = None):
    """Returns (problem, hp, plan, meta) — meta includes truth params.

    ngrid/n_orders scale a demo down for CI (tests run BASELINE configs 4-5
    end-to-end on CPU in minutes — VERDICT round-1 item 7); the defaults are
    the production-scale configs."""
    key = jax.random.PRNGKey(seed)
    name = name.lower()
    n_orders_cli = n_orders
    if name == "single_lorentzian":
        fn, layout = build_model("model_Single_Lorentzian")
        nu = jnp.linspace(10.0, 90.0, 8192)
        truth = jnp.asarray([12.0, 50.0, 2.0, 1.0])
        model, spec = _make_synthetic(fn, truth, nu, key)
        priors = PriorTable.from_rows([
            ("H", "jeffreys", 0.5, 100.0),
            ("nu0", "uniform", 30.0, 70.0),
            ("width", "jeffreys", 0.2, 20.0),
            ("white", "jeffreys", 0.05, 10.0),
        ])
        p0 = np.asarray([8.0, 48.0, 3.0, 1.5])
        problem = Problem(model_fn=fn, layout=layout, priors=priors,
                          nu=nu, spec=spec, params0=jnp.asarray(p0, jnp.float32),
                          model_meta={"name": "model_Single_Lorentzian",
                                      "spec": None})
        hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6)
        plan = PhasePlan(burnin=1000, learning=4000, acquire=8000, thin=4)
        return problem, hp, plan, {"truth": np.asarray(truth),
                                   "n_temps": 4, "n_chains": 8,
                                   "model": "model_Single_Lorentzian",
                                   "spec_kwargs": {}}

    if name == "harvey_background":
        fn, layout = build_model("model_Harvey_Background")
        nu = jnp.linspace(1.0, 4000.0, 16384)
        truth = jnp.asarray([300.0, 0.02, 4.0, 50.0, 0.004, 4.0,
                             10.0, 0.0008, 2.0, 0.3])
        model = fn(truth, nu)
        nsmooth = 50
        sigma = model / np.sqrt(nsmooth)
        spec = model + sigma * jax.random.normal(key, model.shape)
        priors = PriorTable.from_rows([
            ("A1", "jeffreys", 10.0, 3000.0), ("B1", "jeffreys", 1e-3, 1.0),
            ("p1", "uniform", 1.0, 6.0),
            ("A2", "jeffreys", 1.0, 500.0), ("B2", "jeffreys", 1e-4, 0.1),
            ("p2", "uniform", 1.0, 6.0),
            ("A3", "jeffreys", 0.5, 100.0), ("B3", "jeffreys", 1e-5, 0.01),
            ("p3", "uniform", 1.0, 6.0),
            ("N0", "jeffreys", 0.01, 10.0),
        ])
        p0 = np.asarray(truth) * (1 + 0.3 * np.random.default_rng(seed).standard_normal(10))
        p0 = np.clip(p0, [10, 1e-3, 1.0, 1, 1e-4, 1.0, 0.5, 1e-5, 1.0, 0.01],
                     [3000, 1.0, 6.0, 500, 0.1, 6.0, 100, 0.01, 6.0, 10.0])
        problem = Problem(model_fn=fn, layout=layout, priors=priors,
                          nu=nu, spec=spec,
                          params0=jnp.asarray(p0, jnp.float32),
                          likelihood="chi_square",
                          sigma_spec=jnp.asarray(sigma, jnp.float32),
                          model_meta={"name": "model_Harvey_Background",
                                      "spec": None})
        hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6)
        plan = PhasePlan(burnin=2000, learning=6000, acquire=8000, thin=4)
        return problem, hp, plan, {"truth": np.asarray(truth),
                                   "n_temps": 4, "n_chains": 8,
                                   "model": "model_Harvey_Background",
                                   "spec_kwargs": {}}

    if name in ("ms_global", "kepler_full"):
        if name == "ms_global":
            n_orders, dnu, numax = 6, 100.0, 2500.0
            n_temps, n_chains, ngrid = 6, 6, ngrid or 40_000
            lmax = 2
            plan = PhasePlan(burnin=3000, learning=12000, acquire=15000, thin=5)
        else:
            n_orders, dnu, numax = 14, 85.0, 2200.0
            n_temps, n_chains, ngrid = 10, 6, ngrid or 120_000
            lmax = 3
            plan = PhasePlan(burnin=4000, learning=20000, acquire=25000, thin=5)
        if n_orders_cli:
            n_orders = n_orders_cli
        n_per_l = tuple(n_orders if l <= lmax else 0 for l in range(4))
        spec_obj = MSGlobalSpec(n_per_l=n_per_l)
        fn, layout = build_model("model_MS_Global_a1etaa3_HarveyLike", spec_obj)

        rng = np.random.default_rng(seed)
        f0 = numax + dnu * (np.arange(n_orders) - n_orders / 2) \
            + rng.normal(0, 0.5, n_orders)
        f0.sort()
        envelope = np.exp(-0.5 * ((f0 - numax) / (0.18 * numax)) ** 2)
        heights = 8.0 * envelope + 0.5
        widths = 1.0 + 2.0 * (f0 - f0[0]) / (f0[-1] - f0[0])
        vis_true = [1.5, 0.53, 0.07][:max(lmax, 1)]
        truth = np.zeros(layout.ndim)
        truth[layout.offset("heights"):layout.offset("heights") + n_orders] = heights
        vo = layout.offset("visibilities")
        truth[vo:vo + len(vis_true)] = vis_true
        for l in range(lmax + 1):
            off = {0: 0.0, 1: dnu / 2, 2: -0.12 * dnu, 3: 0.28 * dnu}[l]
            o = layout.offset(f"freq_l{l}")
            truth[o:o + n_orders] = f0 + off
        ro = layout.offset("rot")
        truth[ro:ro + 4] = [1.2, 1.0, 0.01, 0.0]   # a1, eta_sw, a3, asym
        truth[layout.offset("widths"):layout.offset("widths") + n_orders] = widths
        no = layout.offset("noise")
        truth[no:no + 10] = [50.0, 2e-3, 4.0, 10.0, 4e-4, 2.0, -1, -1, 2.0, 0.2]
        truth[layout.offset("inclination")] = np.deg2rad(55.0)
        truth[layout.offset("trunc")] = 40.0

        half = dnu * (n_orders / 2 + 1)
        nu = jnp.linspace(numax - half, numax + half, ngrid)
        tj = jnp.asarray(truth, jnp.float32)
        model, spec = _make_synthetic(fn, tj, nu, key)

        rows = []
        for i in range(n_orders):
            rows.append((f"H_{i}", "jeffreys", 0.2, 100.0))
        for l in range(1, lmax + 1):
            rows.append((f"V2_{l}", "gaussian", vis_true[l - 1], 0.1))
        if lmax < 1:
            rows.append(("V2_pad", "fix"))
        for l in range(4):
            nl = layout.size(f"freq_l{l}")
            for i in range(nl):
                rows.append((f"f{l}_{i}", "gaussian",
                             float(truth[layout.offset(f"freq_l{l}") + i]), 1.0))
        rows += [("a1", "uniform", 0.0, 8.0), ("eta_sw", "fix"),
                 ("a3", "gaussian", 0.0, 0.1), ("asym", "fix")]
        for i in range(n_orders):
            rows.append((f"W_{i}", "jeffreys", 0.3, 15.0))
        rows += [("An1", "fix"), ("Bn1", "fix"), ("pn1", "fix"),
                 ("An2", "fix"), ("Bn2", "fix"), ("pn2", "fix"),
                 ("An3", "fix"), ("Bn3", "fix"), ("pn3", "fix"),
                 ("N0", "jeffreys", 0.02, 5.0),
                 ("inc", "uniform", 0.0, np.pi / 2),
                 ("trunc", "fix")]
        priors = PriorTable.from_rows(rows)
        assert priors.ndim == layout.ndim, (priors.ndim, layout.ndim)
        p0 = truth.copy()
        # Perturb free params by ~0.3 PRIOR-scale sigmas, not a fraction of
        # the value: a 5%-of-value kick moves a 2200 uHz frequency ~100 prior
        # sigmas outside its Gaussian(1.0) prior, stranding every walker in a
        # prior-gradient desert it takes >1e5 steps to cross (the mis-mixing
        # this caused was the worst statistical bug of round 1).  The
        # reference's .model files likewise start near the expected solution.
        free = priors.free_mask
        from tamcmc_tpu.sampler.mala import default_init_scales
        _prob0 = Problem(model_fn=fn, layout=layout, priors=priors, nu=nu,
                         spec=spec, params0=jnp.asarray(p0, jnp.float32))
        scales = np.asarray(default_init_scales(_prob0))   # (Df,) prior-based
        p0[free] = p0[free] + 3.0 * scales * rng.standard_normal(free.sum())
        # static truncation windows anchored at p0 (reference c*Gamma
        # algorithm; 10 uHz margin >> the 5-sigma prior wander of any
        # frequency) — ~5-10x less Lorentzian arithmetic per step
        import dataclasses as _dc
        hint = (tuple(float(v) for v in p0),
                float(numax - half), float(2 * half / (ngrid - 1)),
                int(ngrid), 10.0)
        spec_win = _dc.replace(spec_obj, window_hint=hint)
        fn, layout = build_model("model_MS_Global_a1etaa3_HarveyLike", spec_win)
        from tamcmc_tpu.stats.assemblers import build_family_constraints
        extra = build_family_constraints("model_MS_Global_a1etaa3_HarveyLike",
                                         layout)
        problem = Problem(model_fn=fn, layout=layout, priors=priors,
                          nu=nu, spec=spec, params0=jnp.asarray(p0, jnp.float32),
                          extra_logp=extra,
                          model_meta={"name": "model_MS_Global_a1etaa3_HarveyLike",
                                      "spec": spec_win})
        hp = MALAHyper(use_drift=True, dN_mixing=10,
                       lambda_temp=1.35 if name == "kepler_full" else 1.5)
        return problem, hp, plan, {"truth": truth, "n_temps": n_temps,
                                   "n_chains": n_chains,
                                   "model": "model_MS_Global_a1etaa3_HarveyLike",
                                   "spec_kwargs": {"n_per_l": n_per_l}}

    if name == "ajfit":
        # a-coefficient table fit (io_ajfit [U]): 3 l=1 + 3 l=2 multiplets
        # around numax, truth aj + a gate-filter activity band; data =
        # nu_nlm + Gaussian noise, chi_square likelihood over the table.
        from tamcmc_tpu.models.ajfit import AjFitSpec
        spec_obj = AjFitSpec(l_per_multiplet=(1, 1, 1, 2, 2, 2))
        fn, layout = build_model("model_ajfit", spec_obj)
        rng = np.random.default_rng(seed)
        dnu = 100.0
        nu_nl = 2200.0 + dnu * np.arange(6) + rng.normal(0, 0.3, 6)
        nu_nl[3:] -= 0.12 * dnu + 250.0          # l=2 ridge offset
        nu_nl.sort()
        truth = np.zeros(layout.ndim)
        truth[layout.offset("nu_nl"):layout.offset("nu_nl") + 6] = nu_nl
        ao = layout.offset("aj")
        truth[ao:ao + 6] = [0.40, 0.030, 0.015, 0.004, 0.002, 0.001]
        aco = layout.offset("activity")
        truth[aco:aco + 3] = [5e-4, np.deg2rad(20.0), np.deg2rad(15.0)]
        n_pts = spec_obj.n_points
        sigma = np.full(n_pts, 0.03)
        tj = jnp.asarray(truth, jnp.float32)
        nu_idx = jnp.arange(n_pts, dtype=jnp.float32)
        model = fn(tj, nu_idx)
        spec = model + jnp.asarray(sigma) * jax.random.normal(key, (n_pts,))
        rows = []
        for i in range(6):
            rows.append((f"nu_{i}", "gaussian", float(nu_nl[i]), 0.5))
        rows += [("a1", "uniform", 0.0, 2.0),
                 ("a2", "gaussian", 0.0, 0.2),
                 ("a3", "gaussian", 0.0, 0.2),
                 ("a4", "gaussian", 0.0, 0.05),
                 ("a5", "gaussian", 0.0, 0.05),
                 ("a6", "gaussian", 0.0, 0.05),
                 ("epsilon", "uniform", 0.0, 5e-3),
                 ("theta0", "uniform", 0.0, np.pi / 2),
                 ("delta", "uniform", np.deg2rad(2.0), np.deg2rad(45.0))]
        priors = PriorTable.from_rows(rows)
        assert priors.ndim == layout.ndim, (priors.ndim, layout.ndim)
        p0 = truth.copy()
        p0[6:12] = [0.3, 0.0, 0.0, 0.0, 0.0, 0.0]
        p0[12:15] = [1e-3, np.deg2rad(30.0), np.deg2rad(10.0)]
        from tamcmc_tpu.stats.assemblers import build_family_constraints
        extra = build_family_constraints("model_ajfit", layout)
        problem = Problem(model_fn=fn, layout=layout, priors=priors,
                          nu=nu_idx, spec=spec,
                          params0=jnp.asarray(p0, jnp.float32),
                          likelihood="chi_square",
                          sigma_spec=jnp.asarray(sigma, jnp.float32),
                          extra_logp=extra,
                          model_meta={"name": "model_ajfit",
                                      "spec": spec_obj})
        hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.6)
        plan = PhasePlan(burnin=1500, learning=5000, acquire=8000, thin=4)
        return problem, hp, plan, {"truth": truth, "n_temps": 4,
                                   "n_chains": 8, "model": "model_ajfit",
                                   "spec_kwargs": {
                                       "l_per_multiplet": (1, 1, 1, 2, 2, 2)}}

    if name in ("subgiant_mixed", "subgiant_mixed_inertia"):
        # BASELINE config 5: dense l=1 mixed modes from the ARMM solver.
        # The _inertia variant turns on the bump_DP-style mode-inertia
        # height suppression (models/asymptotic.py height_kind switch).
        height_kind = ("inertia" if name.endswith("_inertia")
                       else "equipartition")
        from tamcmc_tpu.models.asymptotic import RGBAsymptSpec
        from tamcmc_tpu.ops.armm import count_poles
        dnu, dpi1, eps_g, qq = 10.0, 80.0, 0.0, 0.15
        numin, numax_w = 100.0, 160.0
        n_orders = n_orders_cli or 5
        n_p, n_g = count_poles(dnu, dpi1, 0.4, eps_g, numin, numax_w)
        spec_obj = RGBAsymptSpec(n_orders=n_orders, numin=numin,
                                 numax_win=numax_w, n_p_poles=n_p,
                                 n_g_poles=n_g, height_kind=height_kind)
        fn, layout = build_model("model_RGB_asympt_a1etaa3_HarveyLike", spec_obj)
        truth = np.zeros(layout.ndim)
        f0 = 100.0 + dnu * (np.arange(n_orders) + 0.4)
        truth[layout.offset("heights"):layout.offset("heights") + n_orders] = 6.0
        vo = layout.offset("visibilities")
        truth[vo:vo + 2] = [1.5, 0.53]
        truth[layout.offset("freq_l0"):layout.offset("freq_l0") + n_orders] = f0
        truth[layout.offset("freq_l2"):layout.offset("freq_l2") + n_orders] = f0 - 1.2
        # O(2) terms (delta0l, alpha_p, alpha_g) zero: first-order truth —
        # the solver's bump_DP-depth extensions are exercised in test_armm
        truth[layout.offset("mixed"):layout.offset("mixed") + 6] = \
            [dpi1, eps_g, qq, 0.0, 0.0, 0.0]
        truth[layout.offset("rot"):layout.offset("rot") + 3] = [0.05, 0.4, 0.0]
        truth[layout.offset("widths"):layout.offset("widths") + n_orders] = 0.15
        no = layout.offset("noise")
        truth[no:no + 10] = [20.0, 0.05, 2.0, -1, -1, 2, -1, -1, 2, 0.1]
        truth[layout.offset("inclination")] = np.deg2rad(60.0)
        nu = jnp.linspace(numin, numax_w, ngrid or 60_000)
        tj = jnp.asarray(truth, jnp.float32)
        model, spec = _make_synthetic(fn, tj, nu, key)
        rows = []
        for i in range(n_orders):
            rows.append((f"H_{i}", "jeffreys", 0.2, 100.0))
        rows += [("V2_1", "gaussian", 1.5, 0.1), ("V2_2", "gaussian", 0.53, 0.08)]
        for i in range(n_orders):
            rows.append((f"f0_{i}", "gaussian", float(f0[i]), 0.3))
        for i in range(n_orders):
            rows.append((f"f2_{i}", "gaussian", float(f0[i] - 1.2), 0.3))
        rows += [("DPi1", "uniform", 60.0, 100.0),
                 ("eps_g", "uniform", -0.5, 0.5),
                 ("q", "uniform", 0.02, 0.5),
                 ("delta0l", "fix"), ("alpha_p", "fix"), ("alpha_g", "fix"),
                 ("a1_env", "uniform", 0.0, 0.5),
                 ("a1_core", "uniform", 0.0, 1.5),
                 ("asym", "fix")]
        for i in range(n_orders):
            rows.append((f"W_{i}", "jeffreys", 0.02, 2.0))
        rows += [("An1", "fix"), ("Bn1", "fix"), ("pn1", "fix"),
                 ("An2", "fix"), ("Bn2", "fix"), ("pn2", "fix"),
                 ("An3", "fix"), ("Bn3", "fix"), ("pn3", "fix"),
                 ("N0", "jeffreys", 0.01, 2.0),
                 ("inc", "uniform", 0.0, np.pi / 2),
                 ("trunc", "fix")]
        priors = PriorTable.from_rows(rows)
        assert priors.ndim == layout.ndim, (priors.ndim, layout.ndim)
        rng = np.random.default_rng(seed)
        p0 = truth.copy()
        free = priors.free_mask
        p0[free] *= (1 + 0.01 * rng.standard_normal(free.sum()))
        from tamcmc_tpu.stats.assemblers import build_family_constraints
        extra = build_family_constraints(
            "model_RGB_asympt_a1etaa3_HarveyLike", layout)
        problem = Problem(model_fn=fn, layout=layout, priors=priors,
                          nu=nu, spec=spec, params0=jnp.asarray(p0, jnp.float32),
                          extra_logp=extra,
                          model_meta={"name": "model_RGB_asympt_a1etaa3_HarveyLike",
                                      "spec": spec_obj})
        hp = MALAHyper(use_drift=True, dN_mixing=10, lambda_temp=1.3)
        plan = PhasePlan(burnin=4000, learning=15000, acquire=20000, thin=5)
        return problem, hp, plan, {"truth": truth, "n_temps": 8, "n_chains": 6,
                                   "model": "model_RGB_asympt_a1etaa3_HarveyLike",
                                   "spec_kwargs": {
                                       "n_orders": n_orders, "numin": numin,
                                       "numax_win": numax_w, "n_p_poles": n_p,
                                       "n_g_poles": n_g,
                                       "height_kind": height_kind}}

    raise KeyError(f"unknown demo '{name}'; have single_lorentzian, "
                   "harvey_background, ms_global, kepler_full, "
                   "subgiant_mixed, subgiant_mixed_inertia, ajfit")
