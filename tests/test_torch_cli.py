"""The real-data training slice as a whole: `python -m ntm_tracker_tpu_torch
--device cpu` preprocess -> cache-features -> train-offsets on a synthetic
VID tree, from a checkpoint of the JAX package's initialized weights
(carried by interop.py). Step 0's train loss in metrics.jsonl equals the
JAX package's OffsetExperiment.loss_fn on its own first
token_batch_iterator batch; the DNC core and the raw-frame route run.
The lab's commands (tests/test_cli_smoke.py's lab classes) run on the same
tree: train-heatmap (its step 0 against JAX's HeatmapExperiment too),
train-offsets --save_imgs, lstm-only, sanity-check (raw, PCA, a trained
compressor, and its two refusals), find-validation-batch, inspect-batch,
copy-paste, dnc-repeat-copy, and train-wholeframe and train-active-resize
on a small generated_sequences.pkl."""

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


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_dist_flags_at_world_one_equal_the_plain_run(workdir, jax_init, monkeypatch, one_thread):
    """--dist_* at world size 1 (a gloo group on the CPU) runs the same
    validation and step, bit for bit, as the run without: one rank's
    all-reduce is the identity; the group ends with the command."""
    monkeypatch.chdir(workdir)
    _, _, ckpt = jax_init
    losses = []
    for extra in ([], ["--dist_coordinator", f"127.0.0.1:{_free_port()}", "--dist_num_processes", "1",
                       "--dist_process_id", "0"]):
        run = train(*TRAIN, "--feature_cache", "cache", "--ckpt_path", ckpt, "--limit", "1",
                    "--validation_interval", "1", "--log_dir", "log_dist", *extra)
        assert run["steps"] == 1 and (run["rank"], run["world"]) == (0, 1)
        assert run["backend"] == (None if not extra else "gloo")
        losses.append([(r.get("train_loss"), r.get("val_loss")) for r in metrics(run)])
    assert losses[0] == losses[1] and len(losses[0]) == 2 and not torch.distributed.is_initialized()


def test_two_ranks_train_offsets(workdir):
    """Two `train-offsets` processes over gloo: each rank trains on its own
    shard (1 of the 2 train sequences, 1 row of --batch_size 2); the
    single val sequence gives both ranks an empty shard; rank 0 alone
    writes metrics and checkpoints."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "ntm_tracker_tpu_torch", "--device", "cpu", "train-offsets", *TRAIN[:-4],
            "--batch_size", "2", "--log_interval", "1", "--feature_cache", "cache", "--validation_interval", "1",
            "--dist_coordinator", f"127.0.0.1:{port}", "--dist_num_processes", "2"]
    procs = [subprocess.Popen([*base, "--dist_process_id", str(r), "--log_dir", f"log_ranks{r}"], cwd=workdir,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"1 train seqs, 0 val seqs (process {r}/2)" in out, out[-3000:]
    assert "trained 1 steps" in outs[0] and "trained" not in outs[1]
    (run0,) = os.listdir(os.path.join(workdir, "log_ranks0"))
    with open(os.path.join(workdir, "log_ranks0", run0, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0] and np.isfinite(recs[0]["train_loss"])
    assert CheckpointManager(os.path.join(workdir, "log_ranks0", run0, "ckpt")).steps() == [0, 1]
    assert not os.path.exists(os.path.join(workdir, "log_ranks1"))


def test_cache_features_shard_raises_and_cuda_is_the_default(tmp_path):
    """--shard builds (its own refusals are the build's: an empty tree has
    no frame records); cuda is every command's default device."""
    with pytest.raises(ValueError, match="no frame records"):
        cli.main(["--device", "cpu", "cache-features", "--sequences_dir", str(tmp_path),
                  "--cache_dir", str(tmp_path), "--shard"])
    assert cli.build_parser().parse_args(["preprocess", "--annotation_dir", "a", "--image_dir", "b",
                                          "--output_dir", "c"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["train-offsets", *TRAIN])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["cache-features", "--sequences_dir", str(tmp_path), "--cache_dir", str(tmp_path)])


def test_cache_features_shard_equals_the_unsharded_cache(workdir, monkeypatch, capsys, one_thread):
    monkeypatch.chdir(workdir)
    cli.main(["--device", "cpu", "cache-features", "--sequences_dir", "cropped", "--cache_dir", "cache_shard",
              "--frames_per_batch", "8", "--shard"])
    assert "sharding the build over 1 of 1 devices" in capsys.readouterr().out
    for root, _, files in os.walk(os.path.join("cache", "base")):
        for f in files:
            other = os.path.join("cache_shard", os.path.relpath(os.path.join(root, f), "cache"))
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(os.path.join(root, f)), np.load(other))


def test_parser_keeps_the_jax_flags_and_defaults():
    """Every flag of the ported commands has the JAX package's default
    (--platform is --device)."""
    ours, theirs = cli.build_parser(), jcli.build_parser()

    def defaults(parser, command):
        sub = next(a for a in parser._actions if a.dest == "command").choices[command]
        return {a.dest: a.default for a in sub._actions if a.dest != "help"}

    for command in ("preprocess", "mine-sequences", "cache-features", "train-offsets", "train-heatmap",
                    "dnc-repeat-copy", "copy-paste", "train-wholeframe", "train-active-resize", "lstm-only",
                    "sanity-check", "find-validation-batch", "inspect-batch", "track-vot", "validate",
                    "convert-vgg", "convert-ntm", "convert-dnc", "export-serving", "bench"):
        mine, ref = defaults(ours, command), defaults(theirs, command)
        assert mine == ref, command


def test_only_bench_is_missing():
    """No JAX command is missing from the port (bench, the last, came with
    benchmarks.py), and bench dispatches to benchmarks.main on --device."""
    def commands(parser):
        return set(next(a for a in parser._actions if a.dest == "command").choices)

    assert commands(jcli.build_parser()) - commands(cli.build_parser()) == set()
    assert commands(cli.build_parser()) <= commands(jcli.build_parser())
    args = cli.build_parser().parse_args(["--device", "cpu", "bench"])
    assert args.fn is cli.cmd_bench and args.device == "cpu"


def test_profile_steps_traces_its_window(workdir, monkeypatch):
    """train-offsets --profile_steps 1:2 writes one torch.profiler trace
    holding steps 1 and 2 and no other step."""
    monkeypatch.chdir(workdir)
    run = train(*TRAIN, "--feature_cache", "cache", "--num_epochs", "2", "--validation_interval", "100",
                "--profile_steps", "1:2", "--log_dir", "log_profile")
    assert run["steps"] >= 3
    traces = sorted(os.listdir(run["profile_dir"]))
    assert traces == ["steps_1_2.pt.trace.json"]
    with open(os.path.join(run["profile_dir"], traces[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train_step_1", "train_step_2"} <= names
    assert not {"train_step_0", "train_step_3"} & names
    with pytest.raises(ValueError, match="START:STOP"):
        train(*TRAIN, "--feature_cache", "cache", "--profile_steps", "1:2:3")


# ---- the lab's commands -----------------------------------------------------------


def lab(*argv):
    """A lab command in-process on the CPU."""
    return cli.main(["--device", "cpu", *argv])


@pytest.fixture
def one_thread():
    """One intra-op thread for the lab's runs: the plain loop is thousands
    of small ops, which stall on thread hand-offs when the run's workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_heatmap_step0_equals_jax(workdir, monkeypatch, one_thread):
    monkeypatch.chdir(workdir)
    args = ["train-heatmap", *TRAIN, "--feature_cache", "cache", "--serialization", "frame", "--compress_dim", "8",
            "--validation_interval", "1000", "--log_dir", "log_heatmap"]
    run = cli.train_offsets(cli.build_parser().parse_args(["--device", "cpu", *args]))
    assert run["steps"] == 2
    loss0 = next(r["train_loss"] for r in metrics(run) if "train_loss" in r)
    # JAX's experiment from the run's step-0 checkpoint, on the same batch
    jargs = jcli.build_parser().parse_args(args)
    jexp = jcli._make_experiment(jargs, jcli._tracker_config(jargs, "ntm"), None)
    _, train_seqs, _ = get_valid_sequences("cropped", SEQ_LEN)
    tb = next(jfc.token_batch_iterator(train_seqs, 1, "cache", 8, shuffle=True, seed=42))
    saved = CheckpointManager(os.path.join(run["log_dir"], "ckpt")).restore(0)["params"]
    jparams = {"core": {k: v for k, v in _jax_tree(saved["core"]).items()}, "compressor": saved["compressor"].numpy()}
    batch = {"features": tb.features, "gts": tb.gts, "y_offsets": tb.y_offsets, "x_offsets": tb.x_offsets}
    ref = float(jexp.loss_fn(jparams, batch)[0])
    assert abs(loss0 - ref) <= 1e-5 * abs(ref), (loss0, ref)


def _jax_tree(params):
    """The port's NTM params as the JAX pytree (numpy leaves)."""
    return {k: ([{kk: vv.numpy() for kk, vv in layer.items()} for layer in v] if k == "controller" else v.numpy())
            for k, v in params.items()}


def test_train_heatmap_sequential_on_frames_and_save_imgs(workdir, monkeypatch, one_thread):
    monkeypatch.chdir(workdir)
    assert lab("train-heatmap", *TRAIN, "--feature_cache", "cache", "--validation_interval", "1000",
               "--log_dir", "log_hm_seq") == 0
    # train-offsets --save_imgs: the dashboards at each validation, and on
    # frames the crops / offsets / predictions grid
    run = train(*TRAIN, "--limit", "1", "--validation_interval", "1", "--log_dir", "log_imgs", "--save_imgs")
    pngs = sorted(f for f in os.listdir(run["log_dir"]) if f.endswith(".png"))
    assert pngs == ["step_0_memory.png", "step_0_validation.png"]
    assert all(os.path.getsize(os.path.join(run["log_dir"], f)) > 0 for f in pngs)
    cached = train(*TRAIN, "--feature_cache", "cache", "--limit", "1", "--validation_interval", "1",
                   "--log_dir", "log_imgs_cached", "--save_imgs", "--core", "dnc")
    assert [f for f in os.listdir(cached["log_dir"]) if f.endswith(".png")] == ["step_0_memory.png"]
    # the views' forward gives the eval step's loss
    assert np.isfinite([r.get("val_loss", 0.0) for r in metrics(cached)]).all()


def test_lstm_only_sanity_check_and_find_validation_batch(workdir, monkeypatch, capsys, one_thread):
    monkeypatch.chdir(workdir)
    assert lab("lstm-only", *TRAIN, "--num_layers", "1", "--compress_dim", "4", "--log_dir", "log_lstm") == 0
    assert "loss" in capsys.readouterr().out
    for extra, name in (([], "sanity_check"), (["--pca"], "sanity_check")):
        assert lab("sanity-check", *TRAIN, "--compress_dim", "8", "--log_dir", "log_sanity", *extra) == 0
        assert "similarity" in capsys.readouterr().out.lower()
        assert os.path.getsize(os.path.join("log_sanity", name + ".png")) > 0
    assert lab("find-validation-batch", "--sequences_dir", "cropped", "--sequence_length", str(SEQ_LEN),
               "--batch_size", "1", "--target_step", "2") == 0
    assert os.path.exists("validation_seqs_2.pkl")
    assert lab("inspect-batch", "--sequences_dir", "cropped", "--out_dir", "inspect",
               "--sequence_length", str(SEQ_LEN)) == 0
    assert os.path.getsize(os.path.join("inspect", "inspect_batch.png")) > 0


def test_sanity_check_trained_compressor_and_refusals(workdir, monkeypatch, capsys, one_thread):
    monkeypatch.chdir(workdir)
    run = cli.train_offsets(cli.build_parser().parse_args([
        "--device", "cpu", "train-heatmap", *TRAIN, "--feature_cache", "cache", "--serialization", "frame",
        "--compress_dim", "8", "--validation_interval", "1000", "--log_dir", "log_hm_c8"]))
    ckpt = os.path.join(run["log_dir"], "ckpt")
    assert lab("sanity-check", *TRAIN, "--compress_dim", "8", "--compressor_ckpt", ckpt,
               "--log_dir", "log_sanity") == 0
    assert "sanity_check_trained" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="compressor shape"):
        lab("sanity-check", *TRAIN, "--compress_dim", "6", "--compressor_ckpt", ckpt, "--log_dir", "log_sanity")
    with pytest.raises(SystemExit, match="has no .* compressor"):
        lab("sanity-check", *TRAIN, "--compress_dim", "8", "--compressor_ckpt", os.path.join(workdir, "jax_none"),
            "--log_dir", "log_sanity")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        lab("sanity-check", *TRAIN, "--pca", "--compressor_ckpt", ckpt)


def test_copy_paste_and_dnc_repeat_copy(tmp_path, capsys, one_thread):
    assert lab("copy-paste", *TINY, "--batch_size", "4", "--sequence_length", "4", "--num_epochs", "3",
               "--log_dir", str(tmp_path)) == 0
    assert capsys.readouterr().out.count("loss") == 3
    assert lab("dnc-repeat-copy", "--hidden_size", "16", "--memory_size", "8", "--word_size", "8", "--num_bits", "3",
               "--batch_size", "4", "--num_training_iterations", "4", "--report_interval", "2",
               "--checkpoint_interval", "2", "--checkpoint_dir", str(tmp_path / "ckpt")) == 0
    assert "avg training loss" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path / "ckpt")).steps() == [2, 4]


def _tiny_pickle(tmp_path, rng, n_seqs=1, n_frames=4, gt_side=28):
    """generated_sequences.pkl's shape (mining.gen_sequences) with real
    JPEGs, as tests/test_cli_smoke.py builds it."""
    import pickle

    from PIL import Image

    seqs = []
    for s in range(n_seqs):
        frames = []
        for i in range(n_frames):
            p = str(tmp_path / f"s{s}_f{i}.JPEG")
            Image.fromarray((rng.rand(90, 160, 3) * 255).astype(np.uint8)).save(p)
            frames.append((p, (160.0, 90.0), [(40.0 + i, 20.0), (110.0 + i, 70.0)], [rng.rand(gt_side, gt_side) > 0.9]))
        seqs.append((f"seq{s}", "obj", 0, n_frames, frames))
    pkl = tmp_path / "gen.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(seqs, f)
    return str(pkl)


@pytest.mark.parametrize("command,extra", [
    ("train-wholeframe", ["--feature_layer", "conv4/conv4_3"]),
    ("train-wholeframe", ["--feature_layer", "pool5", "--two_step"]),
    ("train-active-resize", []),
], ids=["wholeframe", "wholeframe_pool5_two_step", "active_resize"])
def test_pickle_trainers(tmp_path, command, extra, one_thread):
    pkl = _tiny_pickle(tmp_path, np.random.RandomState(2), gt_side=7 if "pool5" in extra else 28)
    args = cli.build_parser().parse_args([
        "--device", "cpu", command, *TINY, "--pickle_path", pkl, "--sequence_length", "4", "--batch_size", "1",
        "--num_epochs", "2" if command == "train-wholeframe" else "1", "--log_interval", "1", "--compress_dim", "8",
        "--log_dir", str(tmp_path / "log"), *extra])
    run = (cli.train_wholeframe if command == "train-wholeframe" else cli.train_active_resize)(args)
    steps = 2 if command == "train-wholeframe" else 1
    assert run["steps"] == steps and len(run["losses"]) == steps and np.isfinite(run["losses"]).all()
    assert CheckpointManager(os.path.join(run["log_dir"], "ckpt")).steps() == [steps]


def test_lab_commands_need_a_card_unless_told_cpu(tmp_path):
    if not torch.cuda.is_available():
        for argv in (["copy-paste", *TINY], ["dnc-repeat-copy"], ["train-heatmap", *TRAIN],
                     ["lstm-only", *TRAIN], ["sanity-check", *TRAIN], ["inspect-batch", "--sequences_dir", "x"],
                     ["train-wholeframe", "--pickle_path", "x"], ["train-active-resize", "--pickle_path", "x"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(argv)


# ---- export-serving and track-vot through an artifact ------------------------------


def _frames_dir(root, n=3):
    from PIL import Image

    rng = np.random.RandomState(2)
    names = []
    for i in range(n):
        arr = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
        name = f"{i:08d}.jpg"
        Image.fromarray(arr).save(os.path.join(root, name))
        names.append(name)
    with open(os.path.join(root, "images.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "region.txt"), "w") as f:
        f.write("30,20,20,15")


def test_export_serving_int8_and_track_vot(tmp_path, capsys):
    """export-serving --vgg_int8 at the canonical 224 config: the artifact's
    steps against the live int8 frame step, track-vot --serving_npz in file
    mode against live track-vot --vgg_int8, and the --vgg_int8 cross-check
    failing loudly on an exact-path artifact."""
    from ntm_tracker_tpu_torch.models.core import make_core
    from ntm_tracker_tpu_torch.tools.export_serving import ServingModel
    from ntm_tracker_tpu_torch.tracking.tracker import build_frame_step

    out = str(tmp_path / "int8.npz")
    assert cli.main(["--device", "cpu", "export-serving", *TINY, "--vgg_int8", "--out", out]) == 0
    printed = capsys.readouterr().out
    assert "exported init/first/step for platforms ['cpu'] (batch 1, int8 tokens, ntm core" in printed
    model = ServingModel(out, device="cpu")
    assert model.meta["vgg_int8"] is True and model.meta["crop_size"] == 224 and model.meta["num_features"] == 64
    args = cli.build_parser().parse_args(["--device", "cpu", "export-serving", *TINY, "--vgg_int8", "--out", out])
    cfg = cli._tracker_config(args, "ntm")
    core = make_core(cfg)
    vgg, params = cli._load_vgg(args, "cpu"), cli._resolve_tracker_weights(args, cfg, core, "cpu")
    step_first, step_rest = build_frame_step(cfg, core, vgg, params, device="cpu")
    rng = np.random.RandomState(0)
    crop = rng.rand(1, 224, 224, 3).astype(np.float32) * 100 - 50
    gt = np.zeros((1, 64), np.float32)
    with torch.no_grad():
        live_off, live_state = step_first(torch.tensor(crop), torch.tensor(gt), core.init_state(params, 1))
    off, leaves = model.first(crop, gt, model.init_state())
    np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=1e-5)
    crop = rng.rand(1, 224, 224, 3).astype(np.float32) * 100 - 50
    live_off, _ = step_rest(torch.tensor(crop), live_state)
    off, _ = model.step(crop, leaves)
    np.testing.assert_allclose(off.numpy(), live_off.numpy(), rtol=0, atol=1e-5)

    _frames_dir(str(tmp_path))
    regions = []
    for extra in (["--serving_npz", out], [*TINY, "--vgg_int8"]):
        assert cli.main(["--device", "cpu", "track-vot", "--vot_mode", "file", "--workdir", str(tmp_path),
                         *extra]) == 0
        # the file protocol reports a region for every frame, the init frame's
        # too (the reference's vot.py advances only on report): 3 images, 3
        # regions, 4 frames processed
        assert "tracked 4 frames" in capsys.readouterr().out
        regions.append(np.loadtxt(tmp_path / "output.txt", delimiter=","))
    assert regions[0].shape == (3, 4)
    np.testing.assert_allclose(regions[0], regions[1], rtol=0, atol=1e-4)

    exact = str(tmp_path / "exact.npz")
    assert cli.main(["--device", "cpu", "export-serving", *TINY, "--out", exact]) == 0
    with pytest.raises(SystemExit, match="exact token path"):
        cli.main(["--device", "cpu", "track-vot", "--serving_npz", exact, "--vgg_int8", "--workdir", str(tmp_path)])


@pytest.mark.parametrize("bad,msg", [("48x64a", "HxW"), ("0x640", "too small")])
def test_export_serving_rejects_bad_device_loop(tmp_path, bad, msg):
    with pytest.raises(SystemExit, match=msg):
        cli.main(["--device", "cpu", "export-serving", *TINY, "--device_loop", bad, "--out", str(tmp_path / "x.npz")])
