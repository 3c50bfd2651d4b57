"""The real-data training slice as a whole: `python -m ntm_tracker_tpu_torch
--device cpu` preprocess -> cache-features -> train-offsets on a synthetic
VID tree, from a checkpoint of the JAX package's initialized weights
(carried by interop.py). Step 0's train loss in metrics.jsonl equals the
JAX package's OffsetExperiment.loss_fn on its own first
token_batch_iterator batch; the DNC core and the raw-frame route run."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ntm_tracker_tpu import cli as jcli
from ntm_tracker_tpu.data import feature_cache as jfc
from ntm_tracker_tpu.train.experiments import OffsetExperiment as JOffsetExperiment
from ntm_tracker_tpu_torch import cli, interop
from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree
from ntm_tracker_tpu_torch.train.harness import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_LEN = 4
TINY = ["--mem_size", "16", "--mem_dim", "8", "--hidden_size", "24", "--read_head_size", "2"]
TRAIN = [*TINY, "--sequences_dir", "cropped", "--sequence_length", str(SEQ_LEN), "--batch_size", "1",
         "--log_interval", "1"]
SEQS = [
    ("ILSVRC2015_train_00000000", "train", (320, 180), 5),
    ("ILSVRC2015_train_00000001", "train", (320, 180), 5),
    ("ILSVRC2015_val_00000000", "val", (160, 90), 5),
]


def run_module(*argv, cwd):
    """`python -m ntm_tracker_tpu_torch --device cpu <argv>` in `cwd`."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "ntm_tracker_tpu_torch", "--device", "cpu", *argv],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The tree, its records and their float16 token cache, made by the
    port's CLI; relative paths, since the split reads the path."""
    root = str(tmp_path_factory.mktemp("vid"))
    write_vid_tree(root, seed=4, sequences=SEQS)
    out = run_module("preprocess", "--annotation_dir", "Annotations", "--image_dir", "Data",
                     "--output_dir", "cropped", "--num_workers", "1", cwd=root)
    assert "generated 15 frames" in out
    out = run_module("cache-features", "--sequences_dir", "cropped", "--cache_dir", "cache",
                     "--frames_per_batch", "8", cwd=root)
    assert "15 frames cached (float16" in out
    return root


@pytest.fixture(scope="module")
def jax_init(workdir):
    """The JAX package's initialized (params, opt_state) for the tiny
    train-offsets config, and a port checkpoint of the same weights."""
    args = jcli.build_parser().parse_args(["train-offsets", *TRAIN])
    jexp = JOffsetExperiment(jcli._tracker_config(args, "ntm"), None, image_mode="resized")
    params, opt_state = jexp.init(jax.random.PRNGKey(5))
    ckpt = os.path.join(workdir, "jax_init_ckpt")
    CheckpointManager(ckpt).save(0, {
        "params": interop.params_from_flat(interop.flatten_params(params)),
        "opt_state": interop.opt_state_from_flat(interop.flatten_opt_state(opt_state)),
    })
    return jexp, params, ckpt


def train(*argv):
    return cli.train_offsets(cli.build_parser().parse_args(["--device", "cpu", "train-offsets", *argv]))


def metrics(run) -> list:
    with open(os.path.join(run["log_dir"], "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cached_step0_loss_equals_jax(workdir, jax_init, monkeypatch):
    monkeypatch.chdir(workdir)
    jexp, jparams, ckpt = jax_init
    run = train(*TRAIN, "--feature_cache", "cache", "--ckpt_path", ckpt, "--num_epochs", "1",
                "--validation_interval", "1", "--log_dir", "log")
    assert run["steps"] == 2
    recs = metrics(run)
    train_loss = [r["train_loss"] for r in recs if "train_loss" in r]
    val_loss = [r["val_loss"] for r in recs if "val_loss" in r]
    assert len(train_loss) == len(val_loss) == 2 and np.isfinite(train_loss + val_loss).all()

    _, train_seqs, val_seqs = get_valid_sequences("cropped", SEQ_LEN)

    loss_fn = jax.jit(lambda p, b: jexp.loss_fn(p, b)[0])  # one compile for both batches

    def jax_loss(seqs):
        tb = next(jfc.token_batch_iterator(seqs, 1, "cache", 8, shuffle=True, seed=42))
        batch = {"features": tb.features, "gts": tb.gts, "y_offsets": tb.y_offsets, "x_offsets": tb.x_offsets}
        return float(loss_fn(jparams, batch))

    ref = jax_loss(train_seqs)
    assert abs(train_loss[0] - ref) <= 1e-5 * abs(ref), (train_loss[0], ref)
    ref_val = jax_loss(val_seqs)
    assert abs(val_loss[0] - ref_val) <= 1e-5 * abs(ref_val), (val_loss[0], ref_val)
    # a checkpoint at every validation, and the last one
    assert CheckpointManager(os.path.join(run["log_dir"], "ckpt")).steps() == [0, 1, 2]

    # resume: one more epoch from the run's last checkpoint
    again = train(*TRAIN, "--feature_cache", "cache", "--ckpt_path", os.path.join(run["log_dir"], "ckpt"),
                  "--num_epochs", "1", "--validation_interval", "100", "--log_dir", "log_resumed")
    assert again["steps"] == 2 and np.isfinite(metrics(again)[-1]["train_loss"])


def test_dnc_core_takes_a_cached_step(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    run = train(*TRAIN, "--core", "dnc", "--feature_cache", "cache", "--limit", "1",
                "--validation_interval", "100", "--log_dir", "log_dnc")
    assert run["steps"] == 1
    assert np.isfinite([r.get("train_loss", r.get("val_loss")) for r in metrics(run)]).all()


def test_raw_frame_route_host_and_device_resize_agree(workdir, jax_init, monkeypatch):
    monkeypatch.chdir(workdir)
    _, _, ckpt = jax_init
    losses = []
    for extra in ([], ["--device_resize"]):
        run = train(*TRAIN, "--ckpt_path", ckpt, "--limit", "1", "--validation_interval", "100",
                    "--log_dir", "log_raw", *extra)
        assert run["steps"] == 1
        losses.append([r["train_loss"] for r in metrics(run) if "train_loss" in r][0])
    # the same batch and weights; the TF1 resize on the host or on the device
    assert np.isfinite(losses).all() and abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])


@pytest.mark.parametrize("flag,item", [
    (["--save_imgs"], "A6/A8"), (["--profile_steps", "1:2"], "A8"),
    (["--dist_coordinator", "localhost:1"], "A7"), (["--dist_num_processes", "2"], "A7"),
])
def test_unported_train_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        train(*TRAIN, *flag)


def test_cache_features_shard_raises_and_cuda_is_the_default(tmp_path):
    with pytest.raises(NotImplementedError, match="A7"):
        cli.main(["--device", "cpu", "cache-features", "--sequences_dir", str(tmp_path),
                  "--cache_dir", str(tmp_path), "--shard"])
    assert cli.build_parser().parse_args(["preprocess", "--annotation_dir", "a", "--image_dir", "b",
                                          "--output_dir", "c"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train-offsets", *TRAIN])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["cache-features", "--sequences_dir", str(tmp_path), "--cache_dir", str(tmp_path)])


def test_parser_keeps_the_jax_flags_and_defaults():
    """Every flag of the ported commands has the JAX package's default
    (--platform is --device)."""
    ours, theirs = cli.build_parser(), jcli.build_parser()

    def defaults(parser, command):
        sub = next(a for a in parser._actions if a.dest == "command").choices[command]
        return {a.dest: a.default for a in sub._actions if a.dest != "help"}

    for command in ("preprocess", "mine-sequences", "cache-features", "train-offsets"):
        mine, ref = defaults(ours, command), defaults(theirs, command)
        assert mine == ref, command
