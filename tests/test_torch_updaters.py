"""The port's updaters against ``multiverso_tpu.updaters``.

Each updater takes the same numpy-seeded param, state and deltas in both
packages for three steps; the new param and every state leaf must agree
within rtol 1e-6 (float32 on both sides; the only difference is where
each framework rounds an elementwise expression, a few ulps at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiverso_tpu import updaters as jup
from multiverso_tpu_torch import updaters as tup

RTOL, ATOL = 1e-6, 1e-7

OPTIONS = {
    "default": dict(),
    "sgd": dict(learning_rate=0.05),
    "adagrad": dict(learning_rate=0.1, lam=1e-6),
    "momentum": dict(learning_rate=0.05, momentum=0.9),
    "adam": dict(learning_rate=0.01, momentum=0.9, rho=0.999, lam=1e-8),
    "ftrl": dict(learning_rate=0.1, lam=0.01, rho=0.001, momentum=1.0),
}


def _leaves_jax(state):
    """The JAX state's leaves in checkpoint order (sorted dict keys)."""
    return [np.asarray(x) for x in jax.tree.leaves(state)]


def _leaves_torch(state):
    return [state[k].numpy() for k in sorted(state)]


def test_registry_names_match():
    assert tup.updater_names() == jup.updater_names()


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_updater_steps_match_reference(name):
    rng = np.random.default_rng(11)
    shape = (17, 6)
    param = rng.standard_normal(shape).astype(np.float32)
    ju, tu = jup.get_updater(name), tup.get_updater(name)
    jp, js = jnp.asarray(param), ju.init_state(jnp.asarray(param))
    tp = torch.from_numpy(param.copy())
    ts = tu.init_state(tp)
    assert len(_leaves_jax(js)) == len(_leaves_torch(ts))
    for step in range(3):
        delta = rng.standard_normal(shape).astype(np.float32)
        if name == "ftrl":
            delta[0] = 0.0          # an untouched row: the 0/0 guard
        jopt = jup.AddOption(step=step, **OPTIONS[name])
        topt = tup.AddOption(step=step, **OPTIONS[name])
        jp, js = jax.jit(ju.apply)(jp, js, jnp.asarray(delta),
                                   jopt.as_jax())
        tp, ts = tu.apply(tp, ts, torch.from_numpy(delta), topt)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} step {step}")
        for a, b in zip(_leaves_torch(ts), _leaves_jax(js)):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} state, step {step}")
        assert tp.dtype == torch.float32


def test_unknown_updater_raises():
    with pytest.raises(ValueError, match="unknown updater_type"):
        tup.get_updater("banana")


@pytest.mark.parametrize("name", ["sgd", "ftrl"])
def test_default_option_resolution_matches(name):
    j = jup.resolve_default_option(name, None)
    t = tup.resolve_default_option(name, None)
    for field in ("learning_rate", "momentum", "rho", "lam", "step"):
        assert getattr(t, field) == getattr(j, field)


def test_cpu_sqrt_is_correctly_rounded():
    """The updaters' sqrt on the CPU equals IEEE float32 sqrt (numpy's)
    bit for bit, as XLA's and the CUDA kernels' do; torch's own vectorized
    CPU sqrt may miss by an ulp."""
    from multiverso_tpu_torch.updaters.updaters import _sqrt
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal(1 << 20))
         * 10.0 ** rng.uniform(-30, 30, 1 << 20)).astype(np.float32)
    got = _sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
