"""Real multi-process data parallelism of the port: two gloo processes on
the CPU (tests/torch_mp_worker_dp.py), each with 4 of the global batch's 8
rows split over a mesh of two local devices, take one train step through
parallel/mesh.parallel_train_step from the JAX package's initialized
weights (carried by interop.py). Both ranks must agree with each other
and with the JAX package's single-process 8-device step of
tests/test_multiprocess_dp.py's config on the same global batch.

Tolerances: the loss and the updated params at rel 1e-5 (each leaf's
largest difference against its largest magnitude), as
test_multiprocess_dp.py holds JAX's two processes to its single one. The
reduced gradients before the clip, against jax.grad of the global batch's
loss, at 1e-4 of each gradient's largest magnitude: float32 sums over
the batch in other orders through the VGG convs and 4 cell steps. A mean
in place of the sum over ranks is off by a factor of 2, and the clip
(max_gradient_norm 5) would hide it in the params."""

import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from ntm_tracker_tpu.config import DataConfig, NTMConfig, TrackerConfig, TrainConfig
from ntm_tracker_tpu.models.vgg import init_vgg_params
from ntm_tracker_tpu.parallel.mesh import make_mesh, parallel_train_step, shard_batch
from ntm_tracker_tpu.train.experiments import OffsetExperiment, synthetic_offset_batch
from ntm_tracker_tpu_torch import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
GRAD_REL = 1e-4


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS", "NTM_DIST_AUTO")}
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(k, None)
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    return env


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) <= rel * scale


def test_two_process_gloo_step_matches_jax_single_process(tmp_path):
    cfg = TrackerConfig(
        core="ntm",
        ntm=NTMConfig(output_dim=2, mem_size=16, mem_dim=8, controller_hidden_size=32, read_head_size=2),
        data=DataConfig(crop_size=32, resize_hw=(48, 64), gt_width=2),
        train=TrainConfig(batch_size=8, sequence_length=2),
        num_features=4,
        feature_points=((1, 1), (1, 2), (2, 1), (2, 2)),
    )
    vgg = init_vgg_params(jax.random.PRNGKey(0))
    exp = OffsetExperiment(cfg, vgg, image_mode="cropped")
    params, opt_state = exp.init(jax.random.PRNGKey(1))
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **{f"p:{k}": v for k, v in interop.flatten_params(params).items()},
             **{f"o:{k}": v for k, v in interop.flatten_opt_state(opt_state).items()},
             **{f"v:{k}": v for k, v in interop.flatten_vgg_params(vgg).items()})

    port = _free_port()
    worker = os.path.join(ROOT, "tests", "torch_mp_worker_dp.py")
    procs = [subprocess.Popen([sys.executable, worker, str(r), "2", str(port), weights, str(tmp_path / f"r{r}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_clean_env())
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert re.search(r"RESULT loss=([0-9.eE+-]+)", out), out[-3000:]
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    # the two ranks hold the same bits
    assert r0.files == r1.files
    for k in r0.files:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    # JAX's single-process step over its 8 devices, on the same global batch
    mesh = make_mesh()
    batch = synthetic_offset_batch(cfg, np.random.RandomState(0))
    new_params, _o, metrics = parallel_train_step(exp.make_train_step(), mesh, donate_argnums=())(
        params, opt_state, shard_batch(mesh, batch))
    assert float(r0["loss"]) == pytest.approx(float(metrics["loss"]), rel=REL)
    for k, v in interop.flatten_params(new_params).items():
        assert _close(r0[f"p:{k}"], v, REL), k
    grads = jax.grad(lambda p: exp.loss_fn(p, batch)[0])(params)
    for k, v in interop.flatten_params(grads).items():
        assert _close(r0[f"g:{k}"], v, GRAD_REL), (k, float(np.abs(r0[f"g:{k}"] - v).max()), float(np.abs(v).max()))
    # a sum over ranks, not a mean: the gradient norm is the global batch's
    norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in interop.flatten_params(grads).values()))
    got = np.sqrt(sum(float(np.sum(r0[k].astype(np.float64) ** 2)) for k in r0.files if k.startswith("g:")))
    assert got == pytest.approx(norm, rel=1e-4)
