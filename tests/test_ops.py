"""Unit tests: L1 kernels vs closed forms (SURVEY.md section 4, rung 1)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tamcmc_tpu.ops.visibilities import mode_visibility
from tamcmc_tpu.ops.rotation import (
    rl_polynomials, qlm, split_frequencies_a1etaa3, split_frequencies_aj,
)
from tamcmc_tpu.ops.noise import harvey_like, noise_background
from tamcmc_tpu.ops.lorentzian import lorentzian_profile, sum_lorentzians
from tamcmc_tpu.stats.likelihoods import likelihood_chi22p, likelihood_chi_square


class TestVisibilities:
    @pytest.mark.parametrize("l", [0, 1, 2, 3])
    @pytest.mark.parametrize("inc_deg", [0.0, 30.0, 45.0, 60.0, 90.0])
    def test_normalisation(self, l, inc_deg):
        eps = mode_visibility(l, jnp.deg2rad(inc_deg))
        assert eps.shape == (2 * l + 1,)
        np.testing.assert_allclose(float(jnp.sum(eps)), 1.0, rtol=1e-5)

    def test_pole_on_view(self):
        # i=0: only m=0 visible
        for l in (1, 2, 3):
            eps = np.asarray(mode_visibility(l, 0.0))
            assert eps[l] == pytest.approx(1.0, rel=1e-6)
            assert np.all(np.delete(eps, l) < 1e-10)

    def test_l1_closed_form(self):
        i = jnp.deg2rad(37.0)
        eps = np.asarray(mode_visibility(1, i))
        c, s = np.cos(float(i)), np.sin(float(i))
        np.testing.assert_allclose(eps, [0.5 * s**2, c**2, 0.5 * s**2], rtol=1e-6)

    def test_differentiable_in_inclination(self):
        g = jax.grad(lambda i: mode_visibility(2, i)[2])(0.7)
        assert np.isfinite(float(g))


class TestRotation:
    def test_rl_p1_is_m(self):
        for l in (1, 2, 3):
            P = rl_polynomials(l)
            m = np.arange(-l, l + 1)
            np.testing.assert_allclose(P[0], m, atol=1e-12)

    def test_rl_p2_closed_form(self):
        # P2(m) = l*(3m^2 - l(l+1)) / (3l^2 - l(l+1))
        for l in (1, 2, 3):
            P = rl_polynomials(l)
            m = np.arange(-l, l + 1)
            expect = l * (3 * m**2 - l * (l + 1)) / (3 * l**2 - l * (l + 1))
            np.testing.assert_allclose(P[1], expect, atol=1e-10)

    def test_rl_normalisation_and_orthogonality(self):
        l = 3
        P = rl_polynomials(l)
        for j in range(1, 2 * l + 1):
            assert P[j - 1][-1] == pytest.approx(l)
        # discrete orthogonality over m
        for a in range(6):
            for b in range(a + 1, 6):
                assert abs(np.dot(P[a], P[b])) < 1e-8

    def test_qlm_traceless(self):
        for l in (1, 2, 3):
            assert np.sum(qlm(l)) == pytest.approx(0.0, abs=1e-12)

    def test_a1_splitting_linear(self):
        nus = split_frequencies_a1etaa3(1, 1000.0, a1=0.5, eta0=0.0, a3=0.0)
        np.testing.assert_allclose(np.asarray(nus), [999.5, 1000.0, 1000.5],
                                   rtol=1e-6)

    def test_aj_matches_a1etaa3_when_only_a1(self):
        aj = np.zeros(6); aj[0] = 0.4
        got = split_frequencies_aj(2, 2000.0, jnp.asarray(aj, dtype=jnp.float32))
        want = split_frequencies_a1etaa3(2, 2000.0, a1=0.4, eta0=0.0, a3=0.0)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)

    def test_centrifugal_term_sign(self):
        # eta0 > 0 raises m=0 for l=1 (Q_10 > 0) and lowers m=+-1 (Q_1,+-1 < 0)
        nus = np.asarray(split_frequencies_a1etaa3(
            1, 3000.0, a1=5.0, eta0=2.5e6, a3=0.0))
        assert nus[1] > 3000.0                       # m=0 pushed up
        assert nus[2] - 3000.0 < 5.0                 # m=+1 gets 5.0 - |cf|
        assert (nus[2] - nus[0]) / 2 == pytest.approx(5.0, rel=1e-5)


class TestNoise:
    def test_harvey_closed_form(self):
        nu = jnp.asarray([10.0, 100.0, 1000.0])
        got = np.asarray(harvey_like(nu, 5.0, 0.01, 2.0))
        want = 5.0 / (1.0 + (0.01 * np.asarray(nu)) ** 2)
        np.testing.assert_allclose(got, want, rtol=1e-5)

    def test_inactive_component_is_zero(self):
        nu = jnp.linspace(1, 100, 8)
        assert np.all(np.asarray(harvey_like(nu, -1.0, 0.01, 2.0)) == 0.0)

    def test_background_white_floor(self):
        nu = jnp.linspace(1000.0, 4000.0, 16)
        p = jnp.asarray([-1, -1, 2, -1, -1, 2, -1, -1, 2, 0.7],
                        dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(noise_background(nu, p)), 0.7,
                                   rtol=1e-6)

    def test_background_gradient_finite(self):
        nu = jnp.linspace(100.0, 4000.0, 64)
        p = jnp.asarray([10.0, 0.005, 4.0, 3.0, 0.002, 2.0, -1, -1, 2, 0.5])
        g = jax.grad(lambda q: jnp.sum(noise_background(nu, q)))(p)
        assert np.all(np.isfinite(np.asarray(g)))


class TestLorentzian:
    def test_peak_height_and_hwhm(self):
        nu = jnp.asarray([1000.0, 1000.5, 999.5])
        prof = np.asarray(lorentzian_profile(nu, 10.0, 1000.0, 1.0))
        np.testing.assert_allclose(prof, [10.0, 5.0, 5.0], rtol=1e-6)

    def test_asymmetry_skews(self):
        nu0, w = 1000.0, 2.0
        lo = float(lorentzian_profile(nu0 - w, 1.0, nu0, w, asym=0.1))
        hi = float(lorentzian_profile(nu0 + w, 1.0, nu0, w, asym=0.1))
        assert hi > lo  # positive asym pushes power to high frequencies

    def test_sum_matches_loop(self):
        rng = np.random.default_rng(0)
        nu = jnp.linspace(900.0, 1100.0, 501)
        H = rng.uniform(1, 5, 7); C = rng.uniform(950, 1050, 7)
        W = rng.uniform(0.5, 3, 7); B = rng.uniform(-0.05, 0.05, 7)
        got = np.asarray(sum_lorentzians(nu, jnp.asarray(H, dtype=jnp.float32),
                                         jnp.asarray(C, dtype=jnp.float32),
                                         jnp.asarray(W, dtype=jnp.float32),
                                         jnp.asarray(B, dtype=jnp.float32)))
        want = sum(np.asarray(lorentzian_profile(nu, h, c, w, b))
                   for h, c, w, b in zip(H, C, W, B))
        np.testing.assert_allclose(got, want, rtol=2e-5)

    def test_custom_vjp_matches_autodiff(self):
        """Analytic backward pass vs autodiff of the naive profile sum,
        including the asymmetry cotangent.  The grid `nu` is data, never a
        parameter: its cotangent is defined as zero by the kernel (skipping
        a full backward pass), so it is excluded here."""
        rng = np.random.default_rng(3)
        nu = jnp.linspace(90.0, 110.0, 257)
        H = jnp.asarray(rng.uniform(1, 5, 11), jnp.float32)
        C = jnp.asarray(rng.uniform(95, 105, 11), jnp.float32)
        W = jnp.asarray(rng.uniform(0.5, 3, 11), jnp.float32)
        B = jnp.asarray(rng.uniform(-0.1, 0.1, 11), jnp.float32)
        g = jnp.asarray(rng.normal(size=257), jnp.float32)

        def naive(nu, H, C, W, B):
            w = jnp.maximum(W, 1e-6)[:, None]
            x = 2.0 * (nu[None, :] - C[:, None]) / w
            num = (1.0 + B[:, None] * x) ** 2 + (B[:, None]) ** 2
            return jnp.sum(H[:, None] * num / (1.0 + x * x), axis=0)

        def loss_custom(*args):
            return jnp.sum(g * sum_lorentzians(*args))

        def loss_naive(*args):
            return jnp.sum(g * naive(*args))

        g_c = jax.grad(loss_custom, argnums=(1, 2, 3, 4))(nu, H, C, W, B)
        g_n = jax.grad(loss_naive, argnums=(1, 2, 3, 4))(nu, H, C, W, B)
        for a, b, name in zip(g_c, g_n, "H C W B".split()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-3, atol=2e-4, err_msg=name)
        # nu cotangent: zeros by contract
        gnu = jax.grad(loss_custom, argnums=0)(nu, H, C, W, B)
        assert not np.any(np.asarray(gnu))

    def test_zero_height_padding(self):
        nu = jnp.linspace(0.0, 10.0, 11)
        out = sum_lorentzians(nu, jnp.zeros(3), jnp.ones(3) * 5, jnp.ones(3),
                              jnp.zeros(3))
        assert np.all(np.asarray(out) == 0.0)


class TestLikelihoods:
    def test_chi22p_value(self):
        S = jnp.asarray([1.0, 2.0, 3.0])
        M = jnp.asarray([1.5, 1.5, 1.5])
        want = -np.sum(np.log(1.5) + np.asarray(S) / 1.5)
        assert float(likelihood_chi22p(S, M)) == pytest.approx(want, rel=1e-4)

    def test_chi22p_maximised_at_truth(self):
        # E[logL] is maximised when M == E[S]; check on a fine grid
        rng = np.random.default_rng(1)
        truth = 2.0
        S = jnp.asarray(rng.exponential(truth, 20000), dtype=jnp.float32)
        scales = np.linspace(1.0, 4.0, 61)
        lls = [float(likelihood_chi22p(S, jnp.full_like(S, s))) for s in scales]
        best = scales[int(np.argmax(lls))]
        assert abs(best - truth) < 0.15

    def test_chi_square_value(self):
        S = jnp.asarray([1.0, 2.0]); M = jnp.asarray([0.0, 0.0])
        sig = jnp.asarray([1.0, 2.0])
        assert float(likelihood_chi_square(S, M, sig)) == pytest.approx(-1.0)

    def test_mask(self):
        S = jnp.asarray([1.0, 100.0]); M = jnp.asarray([1.0, 1.0])
        mask = jnp.asarray([1.0, 0.0])
        full = float(likelihood_chi22p(S[:1], M[:1]))
        assert float(likelihood_chi22p(S, M, mask)) == pytest.approx(full)

    def test_gradient_wrt_model(self):
        S = jnp.asarray([2.0]);
        g = float(jax.grad(lambda m: likelihood_chi22p(S, m))(jnp.asarray([2.0])) [0])
        # d/dM [-(ln M + S/M)] = -1/M + S/M^2 = 0 at M=S
        assert g == pytest.approx(0.0, abs=1e-6)


class TestGroupedStaticWindows:
    """sum_lorentzians_grouped: the reference's c*Gamma truncation ALGORITHM
    with static trace-time windows (ops/lorentzian.py)."""

    def _comps(self):
        rng = np.random.default_rng(3)
        c = np.sort(rng.uniform(120.0, 880.0, 24)).astype(np.float32)
        h = rng.uniform(1.0, 10.0, 24).astype(np.float32)
        w = rng.uniform(0.8, 3.0, 24).astype(np.float32)
        b = np.zeros(24, dtype=np.float32)
        return h, c, w, b

    def test_matches_dense_within_truncation_tail(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians, sum_lorentzians_grouped,
            make_static_window_groups)
        h, c, w, b = self._comps()
        nu = jnp.linspace(100.0, 900.0, 8192)
        step = 800.0 / 8191
        groups = make_static_window_groups(c, 40.0 * w + 10.0, 100.0, step,
                                           8192, group_size=6)
        # every component appears exactly once
        allidx = sorted(i for g in groups for i in g[0])
        assert allidx == list(range(24))
        dense = sum_lorentzians(nu, jnp.asarray(h), jnp.asarray(c),
                                jnp.asarray(w), jnp.asarray(b))
        grp = sum_lorentzians_grouped(nu, jnp.asarray(h), jnp.asarray(c),
                                      jnp.asarray(w), jnp.asarray(b), groups)
        # truncation tail at x = 2*trunc: H/(1+4*40^2) ~ 1.6e-4 of peak;
        # absolute criterion — relative error is meaningless in far-tail
        # bins where the spectrum is ~0 by construction (truncation zeroes
        # them, exactly like the reference)
        err = np.abs(np.asarray(grp - dense)).max()
        assert err < 2e-3 * float(np.asarray(dense).max()), err
        # at every mode peak (where the science lives) agreement is tight
        peaks = np.searchsorted(np.asarray(nu), c)
        rel_pk = (np.abs(np.asarray(grp - dense))[peaks]
                  / np.asarray(dense)[peaks])
        assert rel_pk.max() < 5e-3, rel_pk.max()

    def test_gradients_flow(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians_grouped, make_static_window_groups)
        h, c, w, b = self._comps()
        nu = jnp.linspace(100.0, 900.0, 4096)
        step = 800.0 / 4095
        groups = make_static_window_groups(c, 40.0 * w + 10.0, 100.0, step,
                                           4096)

        def loss(hh, cc, ww):
            return jnp.sum(sum_lorentzians_grouped(
                nu, hh, cc, ww, jnp.asarray(b), groups) ** 2)

        gh, gc, gw = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(h), jnp.asarray(c), jnp.asarray(w))
        for g in (gh, gc, gw):
            assert np.all(np.isfinite(np.asarray(g)))
            assert np.any(np.asarray(g) != 0)

    def test_off_grid_component_contributes_zero(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians_grouped, make_static_window_groups)
        nu = jnp.linspace(100.0, 900.0, 1024)
        step = 800.0 / 1023
        c = np.asarray([5000.0], dtype=np.float32)   # far off-grid
        groups = make_static_window_groups(c, np.asarray([50.0]), 100.0,
                                           step, 1024)
        out = sum_lorentzians_grouped(nu, jnp.asarray([4.0]), jnp.asarray(c),
                                      jnp.asarray([1.0]),
                                      jnp.asarray([0.0]), groups)
        assert float(jnp.abs(out).max()) == 0.0


class TestPartitionedSegments:
    """partition_window_groups + sum_lorentzians_segments: the disjoint
    concat form of the grouped accumulation (the in-scan hot path; see
    ops/lorentzian.py perf notes)."""

    def _comps(self, K=24, seed=3):
        rng = np.random.default_rng(seed)
        c = np.sort(rng.uniform(120.0, 880.0, K)).astype(np.float32)
        h = rng.uniform(1.0, 10.0, K).astype(np.float32)
        w = rng.uniform(0.8, 3.0, K).astype(np.float32)
        b = rng.uniform(-0.02, 0.02, K).astype(np.float32)
        return h, c, w, b

    def test_partition_is_disjoint_sorted_and_work_preserving(self):
        from tamcmc_tpu.ops.lorentzian import (
            make_static_window_groups, partition_window_groups)
        h, c, w, b = self._comps()
        step = 800.0 / 8191
        groups = make_static_window_groups(c, 40.0 * w + 10.0, 100.0, step,
                                           8192)
        segs = partition_window_groups(groups)
        pos = 0
        for idx, lo, hi in segs:
            assert lo >= pos and hi > lo
            pos = hi
        # identical total (component x bin) work — partitioning must not
        # change the truncation algorithm's cost
        cb_g = sum(len(i) * (hi - lo) for i, lo, hi in groups if hi > lo)
        cb_s = sum(len(i) * (hi - lo) for i, lo, hi in segs)
        assert cb_g == cb_s
        # every live component appears with identical bin coverage
        cover_g = {}
        for idx, lo, hi in groups:
            if hi > lo:
                for i in idx:
                    cover_g[i] = cover_g.get(i, 0) + (hi - lo)
        cover_s = {}
        for idx, lo, hi in segs:
            for i in idx:
                cover_s[i] = cover_s.get(i, 0) + (hi - lo)
        assert cover_g == cover_s

    def test_segments_match_grouped_bitwise_semantics(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians_grouped, sum_lorentzians_segments,
            make_static_window_groups, partition_window_groups)
        h, c, w, b = self._comps()
        nu = jnp.linspace(100.0, 900.0, 8192)
        step = 800.0 / 8191
        groups = make_static_window_groups(c, 40.0 * w + 10.0, 100.0, step,
                                           8192)
        segs = partition_window_groups(groups)
        grp = sum_lorentzians_grouped(nu, jnp.asarray(h), jnp.asarray(c),
                                      jnp.asarray(w), jnp.asarray(b), groups)
        seg = sum_lorentzians_segments(nu, jnp.asarray(h), jnp.asarray(c),
                                       jnp.asarray(w), jnp.asarray(b), segs)
        # same (component, bin) contributions -> f32 reassociation only
        err = np.abs(np.asarray(seg - grp)).max()
        assert err < 1e-5 * float(np.asarray(grp).max()), err

    def test_segments_gradients_match_grouped(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians_grouped, sum_lorentzians_segments,
            make_static_window_groups, partition_window_groups)
        h, c, w, b = self._comps(K=12, seed=5)
        nu = jnp.linspace(100.0, 900.0, 4096)
        step = 800.0 / 4095
        groups = make_static_window_groups(c, 40.0 * w + 10.0, 100.0, step,
                                           4096)
        segs = partition_window_groups(groups)

        def loss(fn, table, hh, cc, ww, bb):
            return jnp.sum(fn(nu, hh, cc, ww, bb, table) ** 2)

        import functools
        args = (jnp.asarray(h), jnp.asarray(c), jnp.asarray(w), jnp.asarray(b))
        gg = jax.grad(functools.partial(loss, sum_lorentzians_grouped, groups),
                      argnums=(0, 1, 2, 3))(*args)
        gs = jax.grad(functools.partial(loss, sum_lorentzians_segments, segs),
                      argnums=(0, 1, 2, 3))(*args)
        for a, bgrad in zip(gg, gs):
            np.testing.assert_allclose(np.asarray(a), np.asarray(bgrad),
                                       rtol=2e-4, atol=1e-4)

    def test_segments_vmap_and_empty(self):
        from tamcmc_tpu.ops.lorentzian import (
            sum_lorentzians_segments, make_static_window_groups,
            partition_window_groups)
        nu = jnp.linspace(100.0, 900.0, 1024)
        step = 800.0 / 1023
        # all components off-grid -> zero everywhere, no crash
        segs = partition_window_groups(make_static_window_groups(
            np.asarray([5000.0]), np.asarray([50.0]), 100.0, step, 1024))
        out = sum_lorentzians_segments(nu, jnp.asarray([4.0]),
                                       jnp.asarray([5000.0]),
                                       jnp.asarray([1.0]),
                                       jnp.asarray([0.0]), segs)
        assert float(jnp.abs(out).max()) == 0.0
        # vmap over a walker batch
        h, c, w, b = self._comps(K=8, seed=7)
        segs = partition_window_groups(make_static_window_groups(
            c, 40.0 * w + 10.0, 100.0, step, 1024))
        hb = jnp.asarray(np.stack([h, 2.0 * h]))
        cb = jnp.asarray(np.stack([c, c + 0.5]))
        wb = jnp.asarray(np.stack([w, w]))
        bb = jnp.asarray(np.stack([b, b]))
        outs = jax.vmap(lambda H, C, W, B: sum_lorentzians_segments(
            nu, H, C, W, B, segs))(hb, cb, wb, bb)
        assert outs.shape == (2, 1024)
        assert np.all(np.isfinite(np.asarray(outs)))


class TestPiecewiseChi22p:
    """likelihood_chi22p_pieces + the Problem fused path: identical to the
    dense model+likelihood composition up to f32 reassociation, for values
    AND gradients (sampler/problem.py _logL_from_full)."""

    def _problem(self):
        from tamcmc_tpu.demos import make_demo
        problem, hp, plan, meta = make_demo("ms_global", seed=0, ngrid=4000,
                                            n_orders=4)
        return problem

    def test_fused_path_matches_dense(self):
        from tamcmc_tpu.stats.likelihoods import likelihood_chi22p
        problem = self._problem()
        assert problem._pieces_hook is not None
        x0 = problem.extract(problem.params0)
        rng = np.random.default_rng(1)
        xs = jnp.asarray(np.asarray(x0)[None, :]
                         * (1 + 1e-3 * rng.standard_normal((4, x0.shape[0])))
                         .astype(np.float32))

        def dense_logL(x):
            full = problem.embed(x)
            return likelihood_chi22p(problem.spec,
                                     problem.model_fn(full, problem.nu))

        a = np.asarray(jax.jit(jax.vmap(problem._logL_only))(xs))
        b = np.asarray(jax.jit(jax.vmap(dense_logL))(xs))
        np.testing.assert_allclose(a, b, rtol=1e-5)
        ga = np.asarray(jax.jit(jax.vmap(jax.grad(problem._logL_only)))(xs))
        gb = np.asarray(jax.jit(jax.vmap(jax.grad(dense_logL)))(xs))
        np.testing.assert_allclose(ga, gb, rtol=5e-3, atol=1e-4)

    def test_pieces_cover_every_bin_exactly_once(self):
        problem = self._problem()
        segs, bg_fn = problem._pieces_hook(problem.params0, problem.nu)
        N = int(problem.nu.shape[0])
        pos = 0
        covered = 0
        for lo, hi, seg in segs:
            assert lo >= pos and hi > lo
            assert seg.shape == (hi - lo,)
            covered += hi - lo
            pos = hi
        assert pos <= N and covered > 0
        # background evaluator returns the requested slice shape
        assert bg_fn(0, 7).shape == (7,)


class TestPiecesInvariantCheck:
    def test_overlapping_segments_rejected(self):
        """likelihood_chi22p_pieces refuses raw OVERLAPPING window groups
        (round-3 advisor): only the disjoint sorted partition from
        partition_window_groups is a valid input — overlap would silently
        double-count bins."""
        from tamcmc_tpu.stats.likelihoods import likelihood_chi22p_pieces
        spec = jnp.ones(100)
        bg = lambda lo, hi: jnp.ones(hi - lo)
        segs = [(0, 30, jnp.ones(30)), (20, 50, jnp.ones(30))]  # overlap
        with pytest.raises(ValueError, match="partition invariant"):
            likelihood_chi22p_pieces(spec, segs, bg)

    def test_out_of_range_segment_rejected(self):
        from tamcmc_tpu.stats.likelihoods import likelihood_chi22p_pieces
        spec = jnp.ones(100)
        bg = lambda lo, hi: jnp.ones(hi - lo)
        with pytest.raises(ValueError, match="partition invariant"):
            likelihood_chi22p_pieces(spec, [(90, 120, jnp.ones(30))], bg)


class TestBf16ProfileStream:
    """The bf16 Lorentzian profile stream (tamcmc run --precision bf16;
    f32 accumulation): values within bf16 quantisation of f32,
    gradients finite and close, f32 restored after."""

    def _setup_case(self):
        rng = np.random.default_rng(3)
        nu = jnp.asarray(np.linspace(1000.0, 1200.0, 4096), jnp.float32)
        K = 24
        H = jnp.asarray(rng.uniform(1, 10, K), jnp.float32)
        Cc = jnp.asarray(rng.uniform(1010, 1190, K), jnp.float32)
        W = jnp.asarray(rng.uniform(0.5, 3.0, K), jnp.float32)
        B = jnp.asarray(rng.uniform(-0.05, 0.05, K), jnp.float32)
        return nu, H, Cc, W, B

    def test_values_and_grads_close_to_f32(self):
        from tamcmc_tpu.ops import lorentzian as lz
        nu, H, Cc, W, B = self._setup_case()

        def loss(h, c, w, b):
            m = jnp.maximum(lz.sum_lorentzians(nu, h, c, w, b) + 0.5, 1e-12)
            return -jnp.sum(jnp.log(m) + 1.0 / m)

        f32_val = np.asarray(lz.sum_lorentzians(nu, H, Cc, W, B))
        f32_grad = [np.asarray(g) for g in
                    jax.grad(loss, argnums=(0, 1, 2, 3))(H, Cc, W, B)]
        # these calls are EAGER (per-call dispatch, no stale jit cache), so
        # the post-trace flip latch is safely reset around the A/B; library
        # callers with jitted models must set precision before building
        lz._reset_precision_guard()
        lz.set_profile_precision("bf16")
        try:
            bf_val = np.asarray(lz.sum_lorentzians(nu, H, Cc, W, B))
            bf_grad = [np.asarray(g) for g in
                       jax.grad(loss, argnums=(0, 1, 2, 3))(H, Cc, W, B)]
        finally:
            lz._reset_precision_guard()
            lz.set_profile_precision("f32")
        # bf16 has ~2^-8 relative precision; sums of K contributions keep
        # the relative error at the same order
        np.testing.assert_allclose(bf_val, f32_val, rtol=0.02,
                                   atol=0.02 * f32_val.max())
        for gb, gf in zip(bf_grad, f32_grad):
            assert np.all(np.isfinite(gb))
            scale = np.abs(gf).max()
            np.testing.assert_allclose(gb, gf, atol=0.05 * scale)

    def test_setter_validates(self):
        from tamcmc_tpu.ops import lorentzian as lz
        with pytest.raises(ValueError):
            lz.set_profile_precision("fp8")

    def test_setter_refuses_post_trace_flip(self):
        """A precision flip AFTER a kernel has traced must raise: compiled
        programs bake the precision in and stale jit caches would serve
        mixed-precision results (round-4 advisor, low)."""
        from tamcmc_tpu.ops import lorentzian as lz
        nu = jnp.linspace(0.0, 10.0, 64)
        lz.sum_lorentzians(nu, jnp.ones(2), jnp.array([3.0, 7.0]),
                           jnp.ones(2), jnp.zeros(2))   # latches _TRACED
        current = "bf16" if lz._BF16 else "f32"
        other = "f32" if lz._BF16 else "bf16"
        with pytest.raises(RuntimeError, match="already traced"):
            lz.set_profile_precision(other)
        lz.set_profile_precision(current)   # re-assert: no-op, allowed
