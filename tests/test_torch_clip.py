"""train/optim.clip_by_global_norm selects on the device: no host branch
(it traces into a graph), optax's numbers on both sides of the threshold,
and optax's NaN behaviour. tests/test_torch_optim.py holds the whole
optimizer against optax."""

import math

import numpy as np
import optax
import jax.numpy as jnp
import pytest
import torch
import torch.fx

from ntm_tracker_tpu_torch.train import optim


def _grads(scale):
    rs = np.random.RandomState(0)
    return [(rs.randn(3, 4) * scale).astype(np.float32), (rs.randn(5) * scale).astype(np.float32)]


def test_clip_has_no_host_branch():
    """A data-dependent Python branch cannot be traced; the select can."""
    def clip(a, b):
        return optim.clip_by_global_norm([a, b], 1.0)

    graph = torch.fx.symbolic_trace(clip)
    assert any(n.target is torch.where for n in graph.graph.nodes)
    for scale in (1e-2, 3.0):
        a, b = (torch.tensor(g) for g in _grads(scale))
        for got, want in zip(graph(a, b), clip(a, b)):
            assert torch.equal(got, want)


@pytest.mark.parametrize("scale", [1e-2, 3.0], ids=["below", "above"])
def test_clip_matches_optax_bit_for_bit(scale):
    g = _grads(scale)
    clip = optax.clip_by_global_norm(1.0)
    jg = [jnp.asarray(x) for x in g]
    want, _ = clip.update(jg, clip.init(jg))
    got = optim.clip_by_global_norm([torch.tensor(x) for x in g], 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    if scale < 1:
        assert all(torch.equal(a, torch.tensor(x)) for a, x in zip(got, g))


def test_nan_norm_gives_nan_as_optax_does():
    g = _grads(1.0)
    g[1][2] = np.nan
    clip = optax.clip_by_global_norm(1.0)
    jg = [jnp.asarray(x) for x in g]
    want, _ = clip.update(jg, clip.init(jg))
    got = optim.clip_by_global_norm([torch.tensor(x) for x in g], 1.0)
    for a, b in zip(got, want):
        assert np.isnan(np.asarray(b)).all() and torch.isnan(a).all()
    assert not math.isnan(float(optim.global_norm([torch.tensor(x) for x in _grads(1.0)])))
