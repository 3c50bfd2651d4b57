"""The port's TF RMSProp + clip_by_global_norm (train/optim.py) against the
JAX package's optax chain: N-step trajectories of params and optimizer
state, with the clip engaged and not, carried across with interop.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig
from ntm_tracker_tpu.models.ntm_cell import init_ntm_params
from ntm_tracker_tpu.train.optim import reference_optimizer as jax_reference_optimizer
from ntm_tracker_tpu.train.optim import tf_rmsprop as jax_tf_rmsprop
from ntm_tracker_tpu_torch.interop import (
    flatten_ntm_params,
    flatten_opt_state,
    ntm_params_from_flat,
    opt_state_from_flat,
)
from ntm_tracker_tpu_torch.train import optim

# float32 on both sides, the same formulas; the only differences are the
# order of the global-norm sum and rsqrt rounding: a few ulps per step of
# values up to ~5e-2 (ulp 3.7e-9)
RTOL, ATOL = 1e-6, 1e-8
STEPS = 6
CFG = JNTMConfig(output_dim=2, mem_size=8, mem_dim=4, controller_hidden_size=6,
                 controller_num_layers=2, read_head_size=2, write_head_size=1)


def _grads(step, scale):
    """A gradient tree made from a numpy seed, shaped like the params."""
    rs = np.random.RandomState(100 + step)
    params = init_ntm_params(jax.random.PRNGKey(0), CFG, 5)
    return jax.tree.map(lambda p: jnp.asarray((rs.randn(*p.shape) * scale).astype(np.float32)), params)


def _assert_close(port_flat, jax_flat):
    assert set(port_flat) == set(jax_flat)
    for k in jax_flat:
        np.testing.assert_allclose(port_flat[k], jax_flat[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("scale,engaged", [(1e-2, False), (3.0, True)], ids=["unclipped", "clipped"])
def test_reference_optimizer_trajectory_matches_optax(scale, engaged):
    jparams = init_ntm_params(jax.random.PRNGKey(0), CFG, 5)
    jopt = jax_reference_optimizer(learning_rate=1e-2, decay=0.95, momentum=0.9, max_gradient_norm=5.0)
    jstate = jopt.init(jparams)
    opt = optim.reference_optimizer(learning_rate=1e-2, decay=0.95, momentum=0.9, max_gradient_norm=5.0)
    params = ntm_params_from_flat(flatten_ntm_params(jparams))
    state = opt.init(params)
    _assert_close(flatten_opt_state(state), flatten_opt_state(jstate))  # ms = 1, mom = 0
    for step in range(STEPS):
        jg = _grads(step, scale)
        assert (float(optax.global_norm(jg)) > 5.0) == engaged
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, state = opt.update(ntm_params_from_flat(flatten_ntm_params(jg)), state, params)
        _assert_close(flatten_ntm_params(params), flatten_ntm_params(jparams))
        _assert_close(flatten_opt_state(state), flatten_opt_state(jstate))


def test_tf_rmsprop_without_clipping_matches_optax():
    jparams = init_ntm_params(jax.random.PRNGKey(1), CFG, 5)
    jopt = jax_tf_rmsprop(1e-3, decay=0.9, momentum=0.5, epsilon=1e-10)
    jstate = jopt.init(jparams)
    opt = optim.tf_rmsprop(1e-3, decay=0.9, momentum=0.5, epsilon=1e-10)
    params = ntm_params_from_flat(flatten_ntm_params(jparams))
    state = opt.init(params)
    for step in range(STEPS):
        jg = _grads(step, 30.0)  # far past any clip: none is applied here
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, state = opt.update(ntm_params_from_flat(flatten_ntm_params(jg)), state, params)
    _assert_close(flatten_ntm_params(params), flatten_ntm_params(jparams))
    _assert_close(flatten_opt_state(state), flatten_opt_state(jstate))


def test_optimizer_state_round_trips_through_interop():
    """A JAX optimizer state after k steps starts the port where JAX is."""
    jparams = init_ntm_params(jax.random.PRNGKey(2), CFG, 5)
    jopt = jax_reference_optimizer(learning_rate=1e-2)
    jstate = jopt.init(jparams)
    for step in range(2):
        updates, jstate = jopt.update(_grads(step, 1.0), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    state = opt_state_from_flat(flatten_opt_state(jstate))
    _assert_close(flatten_opt_state(state), flatten_opt_state(jstate))
    assert set(state) == {"ms", "mom"} and len(state["ms"]["controller"]) == CFG.controller_num_layers
    # ... and the two trajectories go on together from there
    opt = optim.reference_optimizer(learning_rate=1e-2)
    params = ntm_params_from_flat(flatten_ntm_params(jparams))
    for step in range(2, 2 + STEPS):
        jg = _grads(step, 1.0)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, state = opt.update(ntm_params_from_flat(flatten_ntm_params(jg)), state, params)
    _assert_close(flatten_ntm_params(params), flatten_ntm_params(jparams))
    _assert_close(flatten_opt_state(state), flatten_opt_state(jstate))


def test_clip_by_global_norm_matches_optax():
    clip = optax.clip_by_global_norm(1.0)
    for scale in (0.01, 10.0):
        jg = _grads(0, scale)
        want, _ = clip.update(jg, clip.init(jg))
        got = optim.clip_by_global_norm(ntm_params_from_flat(flatten_ntm_params(jg)), 1.0)
        _assert_close(flatten_ntm_params(got), flatten_ntm_params(want))


def test_update_leaves_its_inputs_alone():
    params = {"a": torch.ones(3), "controller": [{"kernel": torch.ones(2, 2)}]}
    opt = optim.reference_optimizer()
    state = opt.init(params)
    grads = optim.tree_map(lambda p: torch.full_like(p, 0.5), params)
    new_params, new_state = opt.update(grads, state, params)
    assert torch.equal(params["a"], torch.ones(3)) and torch.equal(state["ms"]["a"], torch.ones(3))
    assert not torch.equal(new_params["a"], params["a"]) and not torch.equal(new_state["ms"]["a"], state["ms"]["a"])
