"""models/core.MemoryCore against the JAX package's: the same fields in
the same order (a core built positionally from either side's order would
otherwise swap two callables without an error)."""

import dataclasses

import jax
import numpy as np
import torch

from ntm_tracker_tpu.config import NTMConfig as JNTMConfig, TrackerConfig as JTrackerConfig
from ntm_tracker_tpu.models import core as jcore
from ntm_tracker_tpu_torch.config import NTMConfig, TrackerConfig
from ntm_tracker_tpu_torch.models import core as tcore


def test_fields_match_jax_in_order():
    names = [f.name for f in dataclasses.fields(tcore.MemoryCore)]
    assert names == [f.name for f in dataclasses.fields(jcore.MemoryCore)]
    assert names[:4] == ["init_params", "init_state", "unroll", "step"]


def test_make_core_fills_every_ported_field():
    cfg = TrackerConfig(ntm=NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=8, read_head_size=2))
    core = tcore.make_core(cfg)
    params = core.init_params(torch.Generator().manual_seed(0), 6)
    state = core.init_state(params, 3)
    x = torch.tensor(np.random.RandomState(0).randn(3, 6).astype(np.float32))
    logit, stepped = core.step(params, x, state)
    logits, final = core.unroll(params, x[:, None], state, remat=False)
    assert torch.equal(logits[:, 0], logit) and torch.equal(final["M"], stepped["M"])
    assert tuple(state["w"].shape) == (3, cfg.ntm.num_heads, 8)
    view = core.state_view(final)  # the dashboards' observables
    assert view["M"] is final["M"] and view["w"] is final["w"] and view["read"] is final["read"]


def test_init_params_takes_jax_argument_order():
    # JAX's facade is called init_params(rng, input_size), positionally; the
    # port's takes a generator (or None) in the rng's place
    cfg = TrackerConfig(ntm=NTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=8, read_head_size=2))
    core = tcore.make_core(cfg)
    a = core.init_params(torch.Generator().manual_seed(3), 6)
    b = core.init_params(torch.Generator().manual_seed(3), 6, None)
    assert a["controller"][0]["kernel"].shape == (6 + 2 * 4 + 8, 4 * 8)
    assert torch.equal(a["controller"][0]["kernel"], b["controller"][0]["kernel"])
    assert core.init_params(None, 6)["heads_w"].shape == a["heads_w"].shape
    jcfg = JTrackerConfig(ntm=JNTMConfig(mem_size=8, mem_dim=4, controller_hidden_size=8, read_head_size=2))
    jparams = jcore.make_core(jcfg).init_params(jax.random.PRNGKey(0), 6)
    assert np.asarray(jparams["controller"][0]["kernel"]).shape == tuple(a["controller"][0]["kernel"].shape)
