"""Tests for the masked truncated-window Lorentzian accumulation.

`sum_lorentzians_trunc` (reference truncation semantics with static shapes)
is checked against a naive masked profile sum, for values and for its
analytic custom VJP.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tamcmc_tpu.ops.lorentzian import sum_lorentzians_trunc, sum_lorentzians


def _mk(bt=3, nc=7, n=513, seed=0):
    rng = np.random.default_rng(seed)
    nu = jnp.linspace(90.0, 110.0, n)
    H = jnp.asarray(rng.uniform(1, 5, (bt, nc)), jnp.float32)
    C = jnp.asarray(rng.uniform(94, 106, (bt, nc)), jnp.float32)
    W = jnp.asarray(rng.uniform(0.3, 2, (bt, nc)), jnp.float32)
    B = jnp.asarray(rng.uniform(-0.1, 0.1, (bt, nc)), jnp.float32)
    return nu, H, C, W, B


def _naive_masked(nu, H, C, W, B, win):
    w = np.maximum(np.asarray(W), 1e-6)
    x = 2.0 * (np.asarray(nu)[None, None, :] - np.asarray(C)[..., None]) \
        / w[..., None]
    num = (1.0 + np.asarray(B)[..., None] * x) ** 2 + np.asarray(B)[..., None] ** 2
    m = np.abs(np.asarray(nu)[None, None, :] - np.asarray(C)[..., None]) \
        <= np.asarray(win)[..., None]
    return np.sum(np.asarray(H)[..., None] * num / (1 + x * x) * m, axis=-2)


class TestTruncJnp:
    def test_matches_naive_masked(self):
        nu, H, C, W, B = _mk()
        win = 10.0 * W
        got = np.asarray(sum_lorentzians_trunc(nu, H, C, W, B, win))
        want = _naive_masked(nu, H, C, W, B, win)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)

    def test_inf_window_equals_dense(self):
        nu, H, C, W, B = _mk()
        win = jnp.full_like(W, jnp.inf)
        got = np.asarray(sum_lorentzians_trunc(nu, H, C, W, B, win))
        dense = np.stack([
            np.asarray(sum_lorentzians(nu, H[i], C[i], W[i], B[i]))
            for i in range(H.shape[0])])
        np.testing.assert_allclose(got, dense, rtol=2e-5, atol=1e-5)

    def test_negative_window_is_zero(self):
        nu, H, C, W, B = _mk()
        win = jnp.full_like(W, -1.0)
        got = np.asarray(sum_lorentzians_trunc(nu, H, C, W, B, win))
        assert not np.any(got)

    def test_grad_matches_autodiff_of_naive(self):
        nu, H, C, W, B = _mk(bt=2, nc=5, n=257)
        win = 8.0 * W
        g = jnp.asarray(np.random.default_rng(1).normal(size=(2, 257)),
                        jnp.float32)

        def naive_jnp(H, C, W, B):
            w = jnp.maximum(W, 1e-6)[..., None]
            x = 2.0 * (nu - C[..., None]) / w
            num = (1.0 + B[..., None] * x) ** 2 + B[..., None] ** 2
            m = (jnp.abs(nu - C[..., None]) <= win[..., None])
            return jnp.sum(jnp.where(m, H[..., None] * num / (1 + x * x), 0.0),
                           axis=-2)

        def loss_c(*a):
            return jnp.sum(g * sum_lorentzians_trunc(nu, *a, win))

        def loss_n(*a):
            return jnp.sum(g * naive_jnp(*a))

        gc = jax.grad(loss_c, argnums=(0, 1, 2, 3))(H, C, W, B)
        gn = jax.grad(loss_n, argnums=(0, 1, 2, 3))(H, C, W, B)
        for a, b, name in zip(gc, gn, "H C W B".split()):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=3e-3, atol=3e-4, err_msg=name)
