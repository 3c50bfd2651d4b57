"""Shared by the lab's port tests (test_torch_heatmap_experiment.py,
test_torch_active_resize.py, test_torch_memory_dashboards.py,
test_torch_cli.py): JAX trees carried to the port, value-and-grad of a
port loss over a whole parameter tree, and the per-tensor gradient check
against jax.value_and_grad's, keyed by interop.py's paths."""

import jax
import numpy as np
import torch

from ntm_tracker_tpu_torch.interop import flatten_params, params_from_flat
from ntm_tracker_tpu_torch.train.optim import tree_leaves, tree_map

# the lab's tolerances: the loss within LOSS_RTOL of JAX's, every gradient
# within GRAD_TOL of its largest entry (float32 on both sides, summed in
# other orders over tens to hundreds of cell steps)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
# a gradient that is zero in exact arithmetic (the output bias under the
# sequential stream's softmax over one channel's F steps, which a shift
# does not change) keeps the rounding of its terms: each side's stays
# within ZERO_TOL of the largest gradient
ZERO_TOL = 1e-5


def to_port(jtree):
    """A JAX parameter tree as the port's (float32 CPU tensors)."""
    return params_from_flat(flatten_params(jtree))


def port_value_and_grad(loss_fn, params, batch):
    """(loss, aux, grads as a tree shaped like params) of loss_fn(params,
    batch) -> (loss, aux); a param the loss does not reach gets zeros."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    fill = iter([torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(live), grads)])
    return loss.detach(), aux, tree_map(lambda _: next(fill), live)


def jax_value_and_grad(loss_fn, jparams, batch):
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(jparams, batch)
    return loss, aux, grads


def assert_loss_and_grads(loss, grads, jloss, jgrads, loss_rtol=LOSS_RTOL, grad_tol=GRAD_TOL, zero=()):
    """The loss and each gradient against JAX's; the keys in `zero` are
    gradients that vanish in exact arithmetic (see ZERO_TOL)."""
    assert abs(float(loss) - float(jloss)) <= loss_rtol * abs(float(jloss)), (float(loss), float(jloss))
    got, ref = flatten_params(grads), flatten_params(jgrads)
    assert got.keys() == ref.keys()
    largest = max(float(np.abs(r).max()) for r in ref.values())
    for key in zero:
        assert max(float(np.abs(got.pop(key)).max()), float(np.abs(ref.pop(key)).max())) <= ZERO_TOL * largest, key
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, atol=grad_tol * max(float(np.abs(r).max()), 1e-12), err_msg=key)
