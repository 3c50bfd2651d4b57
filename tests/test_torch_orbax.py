"""The port's reader of the JAX package's orbax checkpoints
(train/ocdbt.py, train/orbax_ckpt.py, utils/zstd.py) and the restores
behind train/harness.CheckpointManager, on the CPU:

(1) the OCDBT store's listing and every value against tensorstore's ocdbt
    driver: an orbax tree of many leaves, two process databases merged into
    a root the way orbax merges them (interior B+tree nodes at a small node
    size), and the newest generation of a store whose versions fill
    version-tree nodes; the reader in a process whose global scope holds
    another zstd;
(2) every leaf against the JAX package's own CheckpointManager.restore, bit
    for bit, over each dtype orbax writes and a jax.Array sharded over the 8
    CPU devices (8 chunks); zarr v2 forms orbax does not write (order F,
    "/" separators, no compressor, edge chunks) against tensorstore's zarr
    driver;
(3) the train-offsets, DNC and lab trees restored with a template, with
    partial=True and raw, as the port's own .pt of the same tree, and the
    lab commands' restore helpers and dnc-repeat-copy's resume;
(4) resume parity: JAX takes 2 steps, saves, takes a third; the port
    restores the directory and takes the same third step;
(5) train-offsets --ckpt_path and track-vot --ckpt_path on a JAX directory,
    against the same weights from a .pt;
(6) what the reader refuses: zarr3, use_ocdbt=False, a truncated data
    file, a wrong-shaped template, an empty --ckpt_path; a directory of JAX
    and port steps;
(7) the committed full-width fixture (tests/make_orbax_fixture.py) against
    its JSON's checksums, in the port and in the JAX package.
"""

import hashlib
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ntm_tracker_tpu import cli as jcli
from ntm_tracker_tpu.models.dnc import access as jaccess
from ntm_tracker_tpu.models.dnc import addressing as jaddressing
from ntm_tracker_tpu.models.dnc import dnc as jdnc
from ntm_tracker_tpu.train.experiments import OffsetExperiment as JOffsetExperiment
from ntm_tracker_tpu.train.experiments import synthetic_cached_batch as jsynthetic_cached_batch
from ntm_tracker_tpu.train.harness import CheckpointManager as JCheckpointManager
from ntm_tracker_tpu.train.optim import TFRMSPropState
from ntm_tracker_tpu_torch import cli, interop
from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree
from ntm_tracker_tpu_torch.train import ocdbt, orbax_ckpt
from ntm_tracker_tpu_torch.train.experiments import OffsetExperiment
from ntm_tracker_tpu_torch.train.harness import CheckpointManager
from ntm_tracker_tpu_torch.train.optim import tree_map
from ntm_tracker_tpu_torch.utils import zstd
from tests.test_torch_harness import _dnc_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
TINY = ["--mem_size", "16", "--mem_dim", "8", "--hidden_size", "24", "--read_head_size", "2"]
TRAIN = [*TINY, "--sequences_dir", "cropped", "--sequence_length", "2", "--batch_size", "2", "--log_interval", "1"]
# the tolerances of tests/test_torch_experiment.py's step parity: float32 on
# both sides over T=130 recurrent steps, summed in other orders
LOSS_RTOL, PARAM_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-7, 1e-4, 1e-3


def _np_tree(tree):
    """A port tree as the JAX package holds it: numpy leaves, its
    NamedTuples for the port's (the DNC's states)."""
    types = {"DNCState": jdnc.DNCState, "AccessState": jaccess.AccessState,
             "TemporalLinkageState": jaddressing.TemporalLinkageState}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return types[type(tree).__name__](*map(_np_tree, tree))
    return type(tree)(map(_np_tree, tree))


def _jax_chain(opt_state):
    """The port's {"ms", "mom"} as the JAX trainers' optax chain state."""
    return (optax.EmptyState(), TFRMSPropState(_np_tree(opt_state["ms"]), _np_tree(opt_state["mom"])))


def _same_tree(a, b) -> bool:
    """Equal trees, dicts compared key by key whatever their order; a
    NamedTuple equals a dict of its fields."""
    if hasattr(a, "_fields"):
        a = dict(zip(a._fields, a))
    if hasattr(b, "_fields"):
        b = dict(zip(b._fields, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_same_tree, a, b))
    return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.contiguous().numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype == jnp.bfloat16 else a).tobytes()


def _assert_bit_equal(got, want, where=""):
    """The port's raw restore against orbax's: the same structure (lists for
    sequences, None for empty leaves), tensors of the same dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_bit_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bit_equal(g, w, f"{where}[{i}]")
    elif want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (where, got, want)
    else:
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", where
        assert tuple(got.shape) == w.shape and str(got.dtype).split(".")[-1] == str(w.dtype), (where, got.dtype)
        assert _bits(got) == _bits(w), where


# ---- (1) the OCDBT store against tensorstore ---------------------------------------


def _assert_same_store(path) -> ocdbt.OcdbtReader:
    reader = ocdbt.OcdbtReader(path)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert reader.list() == keys
    for k in keys:
        assert reader.read(k) == kv.read(k).result().value, k
    return reader


def _merged_process_databases(path: str, keys: int):
    """Two process databases merged into a root the way orbax merges them
    (ocdbt_utils.merge_ocdbt_per_process_files: a copy of each process's
    range in one transaction), at a node size small enough for interior
    nodes; values inline (<= 16 bytes) and in data files."""
    ctx = ts.Context()
    config = {"max_decoded_node_bytes": 512, "max_inline_value_bytes": 16, "manifest_kind": "single"}

    def store(sub, **extra):
        return ts.KvStore.open({"driver": "ocdbt", "base": {"driver": "file", "path": os.path.join(path, sub)},
                                **extra}, context=ctx).result()

    for p in range(2):
        kv, txn = store(f"ocdbt.process_{p}", config=config, assume_config=True), ts.Transaction()
        for i in range(keys):
            kv.with_transaction(txn)[f"p{p}.leaf/{i:04d}"] = (b"v%d-" % i) * (i % 9)
        txn.commit_async().result()
    root, txn = store("", config=config, assume_config=True), ts.Transaction(atomic=True)
    for p in range(2):
        store(f"ocdbt.process_{p}").experimental_copy_range_to(root.with_transaction(txn)).result()
    txn.commit_async().result()


def test_ocdbt_equals_tensorstore_on_orbax_and_merged_stores(tmp_path):
    # an orbax tree of 300 leaves: orbax's node limit (100 MB) keeps one leaf node
    tree = {f"leaf{i:03d}": np.full((i % 5 + 1, 3), i, np.float32) for i in range(300)}
    JCheckpointManager(str(tmp_path / "orbax")).save(1, tree)
    reader = _assert_same_store(str(tmp_path / "orbax" / "1" / "default"))
    assert len(reader.list()) == 600 and reader.height == 0
    # at 512-byte nodes, 300 keys a process make interior nodes; the merge
    # writes the root's nodes, whose values lie in the processes' data
    # files under the base paths ocdbt.process_<i>/
    _merged_process_databases(str(tmp_path / "merged"), 300)
    reader = _assert_same_store(str(tmp_path / "merged"))
    assert len(reader.list()) == 600 and reader.height == 3

    def value_bases(node):
        own = {v.file.base_path for v in node.values if isinstance(v, ocdbt.Ref)}
        return own.union(*(value_bases(reader._node(c, node.height - 1, p)) for c, p in node.children))

    assert value_bases(reader._root()) == {"ocdbt.process_0/", "ocdbt.process_1/"}


def test_every_generation_through_the_version_tree(tmp_path):
    """40 one-key commits at arity 4: after each, the manifest's older
    versions sit in version-tree nodes of heights 0-2, which the reader
    reads past to its end; the newest generation's keys and values as
    tensorstore reads them."""
    path = str(tmp_path / "gens")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": {"version_tree_arity_log2": 2}}).result()
    for i in range(40):
        kv.write(f"k{i:03d}", b"x" * i).result()
        reader = _assert_same_store(path)
        assert reader.version.generation == i + 2 and len(reader.list()) == i + 1
    # the oldest generations are still there, in the version tree
    old = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}", "version": 2}).result()
    assert [k.decode() for k in old.list().result()] == ["k000"]


def test_reader_beside_another_zstd_exported_globally(tmp_path):
    """A process that exports another zstd's symbols to the global scope
    (TensorFlow's framework library does: a newer zstd, bound by name into
    the system library's calls to its own API, breaks its frames) still
    reads tensorstore's frames: the reader binds libzstd to itself. In a
    subprocess, since a process loads libzstd once."""
    import importlib.util
    import subprocess
    import sys

    spec = importlib.util.find_spec("tensorflow")
    framework = os.path.join(os.path.dirname(spec.origin), "libtensorflow_framework.so.2")
    path = str(tmp_path / "store")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    for i in range(5):
        kv.write(f"k{i}", b"v" * i).result()
    code = (f"import ctypes, os; ctypes.CDLL({framework!r}, mode=os.RTLD_GLOBAL); "
            "from ntm_tracker_tpu_torch.train.ocdbt import OcdbtReader; "
            f"r = OcdbtReader({path!r}); print([r.read(k) for k in r.list()])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT), cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str([b"v" * i for i in range(5)])


def test_zstd_errors_name_the_frame():
    with pytest.raises(zstd.ZstdError, match="not a zstd frame at node X"):
        zstd.decompress(b"\x00\x01\x02\x03rest", where="node X")
    kv_frame = bytes.fromhex("28b52ffd2005290000") + b"hello"  # a raw block with content size 5
    assert zstd.decompress(kv_frame) == b"hello"
    with pytest.raises(zstd.ZstdError, match="cut short|cannot decode"):
        zstd.decompress(kv_frame[:-2], where="chunk c")
    assert zstd.version().count(".") == 2


# ---- (2) every leaf against orbax's restore ------------------------------------------


def test_every_dtype_and_the_sharded_array_equal_orbax_bit_for_bit(tmp_path):
    r = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()), ("d",))
    sharded = jax.device_put(jnp.asarray(r.standard_normal((64, 10)), jnp.float32),
                             NamedSharding(mesh, PartitionSpec("d", None)))
    tree = {"f32": r.standard_normal((3, 4)).astype(np.float32), "f16": r.standard_normal(5).astype(np.float16),
            "bf16": jnp.asarray(r.standard_normal((2, 3)), jnp.bfloat16),
            "i4": np.arange(6, dtype=np.int32).reshape(2, 3), "i8": np.arange(-2, 2, dtype=np.int64),
            "b1": np.array([True, False, True]), "zero_d": np.float32(3.5), "zero_d_int": np.array(7, np.int32),
            "py_int": 42, "py_float": 2.5, "seq": [np.ones(2, np.float32), None, {"x": np.zeros(3, np.float32)}],
            "sharded": sharded}
    JCheckpointManager(str(tmp_path)).save(3, tree)
    want = JCheckpointManager(str(tmp_path)).restore(3)
    got = CheckpointManager(str(tmp_path)).restore()
    _assert_bit_equal(got, want)
    assert got["bf16"].dtype == torch.bfloat16 and type(got["py_int"]) is int
    store = ocdbt.OcdbtReader(str(tmp_path / "3" / "default"))
    assert [k for k in store.list() if k.startswith("sharded/") and not k.endswith(".zarray")] == \
        [f"sharded/{i}.0" for i in range(8)]


def test_zarr_forms_orbax_does_not_write(tmp_path):
    """order F, "/" separators, no compressor and edge chunks, written by
    tensorstore's zarr driver over an OCDBT store; a chunk never written
    (tensorstore leaves out the fill value's) raises naming it."""
    path, a = str(tmp_path), np.arange(35, dtype=np.float32).reshape(5, 7) * 0.5
    for name, meta in (("f_order", {"order": "F", "dimension_separator": "/", "compressor": {"id": "zstd", "level": 1}}),
                       ("raw", {"compressor": None}), ("zstd", {"compressor": {"id": "zstd", "level": 3}})):
        arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}"}, "path": name,
                       "metadata": {"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4", **meta}, "create": True},
                      ).result()
        arr.write(a).result()
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}"}, "path": "part",
                   "metadata": {"shape": [4], "chunks": [2], "dtype": "<i4", "compressor": None},
                   "create": True}).result()
    arr[:2].write(np.array([1, 2], np.int32)).result()
    store = ocdbt.OcdbtReader(path)
    assert "f_order/2/2" in store.list()
    for name in ("f_order", "raw", "zstd"):
        assert torch.equal(orbax_ckpt.read_array(store, name), torch.from_numpy(a)), name
    with pytest.raises(orbax_ckpt.OrbaxFormatError, match="array part: chunk part/1 is missing"):
        orbax_ckpt.read_array(store, "part")


# ---- (3) the trees restore as the port's own .pt does ----------------------------


def _jax_tiny_offsets(seed=5):
    """The JAX package's OffsetExperiment at the CLI's TINY widths, L=2
    (T=130), B=2, and its initial (params, opt_state)."""
    args = jcli.build_parser().parse_args(["train-offsets", *TRAIN])
    jexp = JOffsetExperiment(jcli._tracker_config(args, "ntm"), None, image_mode="resized")
    return (jexp, *jexp.init(jax.random.PRNGKey(seed)))


def _port_tiny_offsets():
    args = cli.build_parser().parse_args(["--device", "cpu", "train-offsets", *TRAIN])
    exp = OffsetExperiment(cli._tracker_config(args, "ntm"), None, image_mode="resized", device="cpu")
    return (exp, *exp.init(torch.Generator().manual_seed(0)))


def _trees():
    """(port tree, the same tree as the JAX package saves it, a port
    template) for the train-offsets, DNC and lab checkpoints."""
    _, jparams, jopt = _jax_tiny_offsets()
    _, tparams, topt = _port_tiny_offsets()
    ntm = {"params": interop.params_from_flat(interop.flatten_params(jparams)),
           "opt_state": interop.opt_state_from_flat(interop.flatten_opt_state(jopt))}
    dnc = _dnc_tree(0)
    g = torch.Generator().manual_seed(3)
    lab_params = {"core": ntm["params"], "compressor": torch.randn(512, 8, generator=g)}
    lab = {"params": lab_params, "opt_state": {"ms": tree_map(torch.ones_like, lab_params),
                                               "mom": tree_map(lambda t: torch.rand(t.shape, generator=g), lab_params)}}
    lab_tmpl = {"params": {"core": tparams, "compressor": torch.zeros(512, 8)},
                "opt_state": {"ms": tree_map(torch.zeros_like, {"core": tparams, "compressor": torch.zeros(512, 8)}),
                              "mom": tree_map(torch.zeros_like, {"core": tparams, "compressor": torch.zeros(512, 8)})}}
    out = {}
    for name, tree, tmpl in (("train_offsets", ntm, {"params": tparams, "opt_state": topt}),
                             ("dnc", dnc, _dnc_tree(1)), ("lab_compressor", lab, lab_tmpl)):
        jtree = {k: (_jax_chain(v) if k == "opt_state" else _np_tree(v)) for k, v in tree.items()}
        out[name] = (tree, jtree, tmpl)
    return out


@pytest.fixture(scope="module")
def saved_trees(tmp_path_factory):
    """Each tree saved by the JAX package's manager and by the port's."""
    root = tmp_path_factory.mktemp("trees")
    out = {}
    for name, (tree, jtree, tmpl) in _trees().items():
        JCheckpointManager(str(root / name / "jax")).save(4, jtree)
        CheckpointManager(str(root / name / "pt")).save(4, tree)
        out[name] = (str(root / name / "jax"), str(root / name / "pt"), tree, tmpl)
    return out


@pytest.mark.parametrize("name", ["train_offsets", "dnc", "lab_compressor"])
def test_trees_restore_as_the_port_pt_does(saved_trees, name):
    jdir, ptdir, tree, tmpl = saved_trees[name]
    jax_mgr, pt_mgr = CheckpointManager(jdir), CheckpointManager(ptdir)
    assert jax_mgr.steps() == pt_mgr.steps() == [4]
    got, ref = jax_mgr.restore(template=tmpl), pt_mgr.restore(template=tmpl)
    assert _same_tree(got, ref) and _same_tree(got, tree)
    if name == "dnc":
        assert type(got["state"]) is type(tmpl["state"])
        assert type(got["state"].access_state.linkage) is type(tmpl["state"].access_state.linkage)
    sub = {"params": tmpl["params"]}
    assert _same_tree(jax_mgr.restore(template=sub, partial=True), pt_mgr.restore(template=sub, partial=True))
    raw, raw_pt = jax_mgr.restore(), pt_mgr.restore()
    assert _same_tree(raw["params"], raw_pt["params"])
    assert raw["opt_state"][0] is None and _same_tree(raw["opt_state"][1], raw_pt["opt_state"])
    if name == "dnc":  # raw NamedTuples are field dicts in both
        assert _same_tree(raw["state"], raw_pt["state"]) and isinstance(raw["state"], dict)
    with pytest.raises(ValueError, match="partial=True"):
        jax_mgr.restore(template=sub)


def test_lab_restore_helpers_take_a_jax_directory(saved_trees):
    """_restore_params (train-wholeframe, train-active-resize, copy-paste,
    and the serving commands through _resolve_tracker_weights) and
    _trained_compressor (--compressor_ckpt, restored raw)."""
    jdir, _, tree, tmpl = saved_trees["lab_compressor"]
    assert _same_tree(cli._restore_params(jdir, tmpl["params"]), tree["params"])
    w = cli._trained_compressor(jdir, 512, 8)
    assert torch.equal(w, tree["params"]["compressor"])
    with pytest.raises(SystemExit, match="compressor shape"):
        cli._trained_compressor(jdir, 512, 6)
    with pytest.raises(SystemExit, match="has no"):
        cli._trained_compressor(saved_trees["train_offsets"][0], 512, 8)


def test_dnc_repeat_copy_resumes_from_the_jax_trainer_directory(tmp_path):
    """The JAX trainer's directory (CheckpointManager(max_to_keep=5) of
    {"params", optax chain}) at step 3: the port resumes there, its first
    iteration's loss that of the JAX params on the task's first batch."""
    from ntm_tracker_tpu_torch.train.dnc_trainer import (
        RepeatCopyTrainConfig, repeat_copy_loss, repeat_copy_setup, train_repeat_copy,
    )

    cfg = RepeatCopyTrainConfig(memory_size=6, word_size=4, num_read_heads=1, hidden_size=8, batch_size=2,
                                checkpoint_interval=10, checkpoint_dir=str(tmp_path), seed=1)
    task, dcfg, params, opt = repeat_copy_setup(cfg, "cpu")
    g = torch.Generator().manual_seed(9)
    saved = tree_map(lambda t: t + torch.rand(t.shape, generator=g), params)
    state = {"ms": tree_map(lambda t: 1 + torch.rand(t.shape, generator=g), params),
             "mom": tree_map(lambda t: torch.rand(t.shape, generator=g), params)}
    JCheckpointManager(str(tmp_path), max_to_keep=5).save(3, {"params": _np_tree(saved), "opt_state": _jax_chain(state)})
    logs = []
    _, losses = train_repeat_copy(cfg, num_iterations=4, log=logs.append, device="cpu")
    assert "resumed from checkpoint step 3" in logs and len(losses) == 1
    want = repeat_copy_loss(saved, dcfg, task.sample(), "cpu")
    assert losses[0] == pytest.approx(float(want), rel=1e-6)


# ---- (4) resume parity ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """JAX at the CLI's TINY widths: 2 steps, a save (step 2), then a third
    step on the same batch; returns the directory, the batch and the third
    step's (loss, params, opt_state)."""
    jexp, params, opt_state = _jax_tiny_offsets()
    step = jax.jit(jexp.make_train_step())
    batch = jsynthetic_cached_batch(jexp.cfg, np.random.RandomState(7))
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, batch)
    ckpt = str(tmp_path_factory.mktemp("jax_resume") / "ckpt")
    JCheckpointManager(ckpt).save(2, {"params": params, "opt_state": opt_state})
    third = step(params, opt_state, batch)
    return ckpt, {k: np.array(v) for k, v in batch.items()}, third


def test_resume_parity_with_the_jax_third_step(jax_resume):
    ckpt, batch, (jparams, jopt, jm) = jax_resume
    exp, params, opt_state = _port_tiny_offsets()
    restored = CheckpointManager(ckpt).restore(template={"params": params, "opt_state": opt_state})
    params, opt_state, m = exp.make_train_step()(restored["params"], restored["opt_state"], batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got = interop.flatten_params(params)
    for k, r in interop.flatten_params(jparams).items():
        np.testing.assert_allclose(got[k], r, atol=PARAM_ATOL, err_msg=k)
    got, want = interop.flatten_opt_state(opt_state), interop.flatten_opt_state(jopt)
    for k, r in want.items():
        if k.startswith("ms/"):
            np.testing.assert_allclose(got[k], r, rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], r, atol=GRAD_ATOL * float(np.abs(r).max()), rtol=GRAD_RTOL, err_msg=k)


# ---- (5) the CLI on a JAX directory ------------------------------------------------


@pytest.fixture(scope="module")
def vid_tree(tmp_path_factory):
    """A small VID tree, preprocessed and cached by the port's CLI in-process;
    relative paths, since the split reads the path."""
    root = str(tmp_path_factory.mktemp("vid"))
    write_vid_tree(root, seed=4, sequences=[("ILSVRC2015_train_00000000", "train", (320, 180), 5),
                                            ("ILSVRC2015_train_00000001", "train", (320, 180), 5),
                                            ("ILSVRC2015_val_00000000", "val", (160, 90), 5)])
    here = os.getcwd()
    os.chdir(root)
    try:
        assert cli.main(["--device", "cpu", "preprocess", "--annotation_dir", "Annotations", "--image_dir", "Data",
                         "--output_dir", "cropped", "--num_workers", "1"]) == 0
        assert cli.main(["--device", "cpu", "cache-features", "--sequences_dir", "cropped", "--cache_dir", "cache",
                         "--frames_per_batch", "8"]) == 0
    finally:
        os.chdir(here)
    return root


def test_train_offsets_resumes_a_jax_directory(vid_tree, jax_resume, monkeypatch):
    """train-offsets --ckpt_path on the JAX directory and on a .pt of the same
    tree: the same losses, bit for bit (params and optimizer state both
    restored); an empty directory raises, with no seeded init."""
    monkeypatch.chdir(vid_tree)
    ckpt = jax_resume[0]
    pt = os.path.join(vid_tree, "pt_ckpt")
    CheckpointManager(pt).save(2, CheckpointManager(ckpt).restore(template={
        "params": _port_tiny_offsets()[1], "opt_state": _port_tiny_offsets()[2]}))
    runs = []
    for path, log in ((ckpt, "log_jax"), (pt, "log_pt")):
        run = cli.train_offsets(cli.build_parser().parse_args([
            "--device", "cpu", "train-offsets", *TRAIN, "--batch_size", "1", "--feature_cache", "cache",
            "--ckpt_path", path, "--num_epochs", "1", "--validation_interval", "100", "--log_dir", log]))
        with open(os.path.join(run["log_dir"], "metrics.jsonl")) as f:
            runs.append([json.loads(line) for line in f])
    losses = [[r.get("train_loss", r.get("val_loss")) for r in recs] for recs in runs]
    assert len(losses[0]) >= 2 and np.isfinite(losses[0]).all() and losses[0] == losses[1]
    os.makedirs("empty_ckpt")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cli.train_offsets(cli.build_parser().parse_args([
            "--device", "cpu", "train-offsets", *TRAIN, "--feature_cache", "cache", "--ckpt_path", "empty_ckpt",
            "--log_dir", "log_empty"]))


def test_track_vot_serves_a_jax_directory(tmp_path, jax_resume, capsys):
    """track-vot --ckpt_path (file protocol) on the JAX directory and on a .pt
    of the same params: the same regions."""
    from PIL import Image

    rng = np.random.RandomState(2)
    names = []
    for i in range(3):
        name = f"{i:08d}.jpg"
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(tmp_path / name)
        names.append(name)
    (tmp_path / "images.txt").write_text("\n".join(names) + "\n")
    (tmp_path / "region.txt").write_text("30,20,20,15")
    pt = str(tmp_path / "pt_ckpt")
    CheckpointManager(pt).save(2, {"params": CheckpointManager(jax_resume[0]).restore(
        template={"params": _port_tiny_offsets()[1]}, partial=True)["params"]})
    regions = []
    for path in (jax_resume[0], pt):
        assert cli.main(["--device", "cpu", "track-vot", "--vot_mode", "file", "--workdir", str(tmp_path), *TINY,
                         "--ckpt_path", path]) == 0
        assert "tracked 4 frames" in capsys.readouterr().out
        regions.append(np.loadtxt(tmp_path / "output.txt", delimiter=","))
    assert regions[0].shape == (3, 4) and np.array_equal(regions[0], regions[1])


# ---- (6) what the reader refuses ----------------------------------------------------


def test_refusals_and_a_mixed_directory(tmp_path):
    tree = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.zeros(3, np.float32)}}
    with ocp.CheckpointManager(str(tmp_path / "zarr3"),
                               item_handlers=ocp.PyTreeCheckpointHandler(use_zarr3=True)) as mgr:
        mgr.save(1, args=ocp.args.PyTreeSave(tree))
    with pytest.raises(NotImplementedError, match="use_zarr3=True"):
        CheckpointManager(str(tmp_path / "zarr3")).restore()
    with ocp.CheckpointManager(str(tmp_path / "no_ocdbt"),
                               item_handlers=ocp.StandardCheckpointHandler(use_ocdbt=False)) as mgr:
        mgr.save(1, args=ocp.args.StandardSave(tree))
    with pytest.raises(NotImplementedError, match="use_ocdbt=False"):
        CheckpointManager(str(tmp_path / "no_ocdbt")).restore()

    jdir = str(tmp_path / "mixed")
    JCheckpointManager(jdir).save(3, tree)
    os.makedirs(os.path.join(jdir, "7.orbax-checkpoint-tmp-123"))  # an unfinished orbax save
    mgr = CheckpointManager(jdir, max_to_keep=1)
    with pytest.raises(ValueError, match=r"at /params/w the template's tensor has shape \(3, 2\)"):
        mgr.restore(template={"params": {"w": torch.zeros(3, 2), "b": torch.zeros(3)}})
    mgr.save(5, {"params": {"w": torch.ones(2, 3), "b": torch.ones(3)}})
    assert mgr.steps() == [3, 5] and mgr.latest_step() == 5
    mgr.save(6, {"params": {"w": torch.ones(2, 3), "b": torch.ones(3)}})  # prunes 5.pt, never the JAX step
    assert mgr.steps() == [3, 6] and os.path.isdir(os.path.join(jdir, "3"))
    assert torch.equal(mgr.restore(3)["params"]["w"], torch.from_numpy(tree["params"]["w"]))

    # a data file cut short: the reader names the file and the range
    bad = str(tmp_path / "truncated")
    shutil.copytree(os.path.join(FIXTURES, "orbax_ntm_full"), bad)
    data = os.path.join(bad, "2", "default", "ocdbt.process_0", "d")
    biggest = max((os.path.join(data, n) for n in os.listdir(data)), key=os.path.getsize)
    with open(biggest, "r+b") as f:
        f.truncate(os.path.getsize(biggest) // 2)
    with pytest.raises(ocdbt.OcdbtError, match="is truncated"):
        CheckpointManager(bad).restore()
    # a flipped byte in a node fails its checksum
    manifest = os.path.join(bad, "2", "default", "manifest.ocdbt")
    raw = bytearray(open(manifest, "rb").read())
    raw[20] ^= 0xFF
    open(manifest, "wb").write(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match="crc32c"):
        CheckpointManager(bad).restore()


# ---- (7) the committed full-width fixture -------------------------------------------


def test_committed_fixture_matches_its_record_in_both_packages():
    with open(os.path.join(FIXTURES, "orbax_ntm_full.json")) as f:
        record = json.load(f)
    want = {r["path"]: r["sha256"] for r in record["leaves"]}
    path = os.path.join(FIXTURES, "orbax_ntm_full")

    def hashes(tree, prefix=()):
        if isinstance(tree, dict):
            return {p: h for k in tree for p, h in hashes(tree[k], prefix + (str(k),)).items()}
        if isinstance(tree, (list, tuple)):
            return {p: h for i, v in enumerate(tree) for p, h in hashes(v, prefix + (str(i),)).items()}
        return {"/".join(prefix): None if tree is None else hashlib.sha256(_bits(tree)).hexdigest()}

    assert CheckpointManager(path).steps() == [record["step"]]
    assert hashes(CheckpointManager(path).restore()) == want
    assert hashes(JCheckpointManager(path).restore(record["step"])) == want
    assert sum(int(np.prod(r["shape"])) for r in record["leaves"] if r["path"].startswith("params/")) == \
        record["num_params"] == 673852
    batch = np.load(os.path.join(FIXTURES, record["next_batch"]["file"]))
    assert batch["features"].shape == (4, 64, 512) and batch["features"].dtype == np.float16
