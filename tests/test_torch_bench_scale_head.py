"""tools/bench_scale_head.py on the CPU at one train step a head: its JSON
line has the JAX tool's keys (the recorded SCALE_HEAD_r05.json run, which
the JAX tool printed), and each training's step-0 loss, from the JAX
package's initialized weights (carried by interop.py), equals the JAX
package's OffsetExperiment.loss_fn on its own training_batch draw.

Tolerance of the losses: rtol 1e-4. The crops differ by float32 rounding
(tests/test_torch_demo.py's CROP_ATOL, 5e-3 on a 255 scale) before the
VGG and 520 cell steps."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ntm_tracker_tpu.models.vgg import init_vgg_params as jinit_vgg
from ntm_tracker_tpu.tracking import demo as jdemo
from ntm_tracker_tpu.train.experiments import OffsetExperiment as JOffsetExperiment
from ntm_tracker_tpu_torch import interop
from ntm_tracker_tpu_torch.tools import bench_scale_head as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4


def _keys(tree):
    return {k: _keys(v) for k, v in tree.items()} if isinstance(tree, dict) else None


def test_one_step_run_has_the_jax_keys_and_losses(monkeypatch, capsys):
    jvgg = jinit_vgg(jax.random.PRNGKey(0))
    tvgg = interop.vgg_params_from_flat(interop.flatten_vgg_params(jvgg))
    jax_init = {}

    class CarriedInit(tool.OffsetExperiment):
        """The port's experiment, initialized with the JAX package's
        weights and optimizer state for the same config."""

        def init(self, generator=None):
            jexp = JOffsetExperiment(jdemo.demo_config(predict_scale=self.cfg.predict_scale), jvgg,
                                     image_mode="cropped")
            p, o = jexp.init(jax.random.PRNGKey(1))
            jax_init[self.cfg.predict_scale] = (jexp, p)
            return (interop.params_from_flat(interop.flatten_params(p), self.device),
                    interop.opt_state_from_flat(interop.flatten_opt_state(o), self.device))

    losses = {}
    real_train = tool.train

    def recording_train(exp, params, opt_state, steps, tag=""):
        out = real_train(exp, params, opt_state, steps, tag)
        losses[exp.cfg.predict_scale] = out[2]
        return out

    monkeypatch.setattr(tool, "OffsetExperiment", CarriedInit)
    monkeypatch.setattr(tool, "train", recording_train)
    monkeypatch.setattr(tool, "init_vgg_params", lambda gen, dev: tvgg)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert tool.main(["1", "0.15", "1", "--device", "cpu", "--eval_frames", "3"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr()
    result = json.loads(out.out.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "SCALE_HEAD_r05.json")) as f:
        recorded = json.load(f)["runs"][0]
    assert _keys(result) == _keys(recorded)
    assert "fused-kernel O=3 parity: max|diff|=" in out.err and "launches: " in out.err

    for predict_scale, (jexp, jp) in jax_init.items():
        batch = jdemo.training_batch(jexp.cfg, np.random.RandomState(0))
        want = float(jax.jit(lambda p, b: jexp.loss_fn(p, b)[0])(jp, batch))
        assert losses[predict_scale][0] == pytest.approx(want, rel=LOSS_RTOL), predict_scale
