"""Every f32 matrix product of the sampler step is pinned at HIGHEST.

On a GPU an unpinned f32 product may run in TF32 (~3 decimal digits); a
proposal built that way no longer matches the exact-xi logq_fwd of its MH
ratio.  The check reads the traced program, so it holds on any backend."""
import numpy as np
import pytest
import jax
from jax.extend.core import ClosedJaxpr, Jaxpr
from jax.lax import Precision

from tamcmc_tpu.sampler import init_state, make_beta_ladder, mala_step


def _dot_precisions(jaxpr):
    """precision params of every dot_general, sub-programs included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, ClosedJaxpr):
                    found += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    found += _dot_precisions(sub)
    return found


def _pinned(p):
    return p is not None and all(x == Precision.HIGHEST for x in p)


def _problem(kind):
    from tamcmc_tpu.sampler import MALAHyper
    if kind == "correlated_gaussian":
        from tamcmc_tpu.sampler.analytic import correlated_gaussian
        cov = np.diag(np.linspace(0.5, 2.0, 6)) + 0.1
        return correlated_gaussian(cov), MALAHyper(use_drift=True)
    from tamcmc_tpu.demos import make_demo
    problem, hp, _, _ = make_demo("ms_global", seed=0, ngrid=2000,
                                  n_orders=2)
    return problem, hp


@pytest.mark.parametrize("kind", ["correlated_gaussian", "ms_global"])
def test_mala_step_products_are_highest(kind):
    problem, hp = _problem(kind)
    T, C = 2, 4
    state = init_state(problem, hp, T, C, jax.random.PRNGKey(0))
    betas = make_beta_ladder(T, hp.lambda_temp)
    jaxpr = jax.make_jaxpr(
        lambda s, k: mala_step(problem, hp, betas, s, k, adapt=True))(
            state, jax.random.PRNGKey(1))
    found = _dot_precisions(jaxpr.jaxpr)
    assert len(found) >= 4          # forward, proposal, reverse drift, r
    assert all(_pinned(p) for p in found), found


def test_aj_splitting_product_is_highest():
    import jax.numpy as jnp
    from tamcmc_tpu.ops.rotation import split_frequencies_aj
    jaxpr = jax.make_jaxpr(lambda nu, aj: split_frequencies_aj(2, nu, aj))(
        jnp.ones((3,)), jnp.ones((3, 6)))
    found = _dot_precisions(jaxpr.jaxpr)
    assert found and all(_pinned(p) for p in found), found
