"""The port's offline preprocessing (data/preprocess.py, data/augment.py,
data/sequences.py) against the JAX package's and the executed reference's
golden: the same .txt/.bin files byte for byte, the same augmented
sub-sequences under a seed, the same sequence selection and batches."""

import os

import numpy as np
import pytest
from synthetic_vid import write_synthetic_vid

from ntm_tracker_tpu.config import DataConfig as JDataConfig
from ntm_tracker_tpu.data import augment as jaug
from ntm_tracker_tpu.data import preprocess as jpre
from ntm_tracker_tpu.data import sequences as jseq
from ntm_tracker_tpu_torch.config import DataConfig
from ntm_tracker_tpu_torch.data import augment, preprocess, sequences
from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
IMAGE_DIR = "/data/ILSVRC2015/Data"  # recorded in the records, never opened


def tree_bytes(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def run_both(tmp_path, anno_dir, image_dir, augmented=False, **kw):
    """(the port's files, the JAX package's files) for one annotation tree."""
    outs = []
    for name, pre, aug, cfg in (("port", preprocess, augment, DataConfig()),
                                ("jax", jpre, jaug, JDataConfig())):
        out = tmp_path / name
        job = pre.PreprocessJob(anno_dir, image_dir, str(out), cfg)
        kw.setdefault("num_workers", 1)
        if augmented:
            aug.run_preprocess_augmented(job, **kw)
        else:
            pre.run_preprocess(job, **kw)
        outs.append(tree_bytes(out))
    return outs


def test_records_byte_identical_to_jax_and_the_golden(tmp_path):
    """Every gate of the reference's old_process_sequence (tests/
    synthetic_vid.py): the port writes the JAX package's files, and those
    of the executed reference (tf_goldens_preprocess.npz)."""
    anno_dir, _ = write_synthetic_vid(str(tmp_path / "in"))
    port, jax_files = run_both(tmp_path, anno_dir, IMAGE_DIR)
    assert port == jax_files
    g = np.load(os.path.join(FIXTURE_DIR, "tf_goldens_preprocess.npz"))
    golden = {str(p): g[f"data_{i}"].tobytes() for i, p in enumerate(g["paths"])}
    assert set(port) == set(golden)
    for p in sorted(golden):
        assert port[p] == golden[p], f"byte mismatch in {p}"


@pytest.mark.parametrize("limit,workers", [(0, 1), (1, 1), (0, 2)])
def test_synthetic_vid_tree_byte_identical(tmp_path, limit, workers):
    """The port's synthetic VID tree (the chip drive's data), with --limit,
    and in two spawned workers (the JAX package forks its own)."""
    anno_dir, image_dir = write_vid_tree(str(tmp_path / "in"), seed=3, sequences=[
        ("ILSVRC2015_train_00000000", "train", (320, 180), 6, 2),
        ("ILSVRC2015_val_00000000", "val", (160, 90), 5),
    ])
    port, jax_files = run_both(tmp_path, anno_dir, image_dir, limit=limit, num_workers=workers)
    assert port == jax_files
    assert len(port) == 2 * (12 if limit else 17)


@pytest.mark.parametrize("seq_length,seed,workers", [(2, 0, 1), (3, 7, 1), (2, 5, 2)])
def test_augment_byte_identical_under_a_seed(tmp_path, seq_length, seed, workers):
    anno_dir, _ = write_synthetic_vid(str(tmp_path / "in"))
    port, jax_files = run_both(tmp_path, anno_dir, IMAGE_DIR, augmented=True, seq_length=seq_length, seed=seed,
                               num_workers=workers)
    assert port and port == jax_files
    # the zlib-keyed streams: the same seed writes the same files again
    job = preprocess.PreprocessJob(anno_dir, IMAGE_DIR, str(tmp_path / "again"))
    augment.run_preprocess_augmented(job, seq_length=seq_length, seed=seed, num_workers=1)
    assert tree_bytes(tmp_path / "again") == port


@pytest.mark.parametrize("raw_length,seq_length", [(20, 4), (23, 5), (7, 7), (40, 3)])
def test_dilation_slices_match_jax(raw_length, seq_length):
    a = augment.dilation_slices(raw_length, seq_length, np.random.default_rng([1, 2, 3]))
    b = jaug.dilation_slices(raw_length, seq_length, np.random.default_rng([1, 2, 3]))
    assert a == b and all(s + st * seq_length <= raw_length for s, st in a)


def test_read_frame_record_and_parse_frame_match_jax(tmp_path):
    anno_dir, _ = write_synthetic_vid(str(tmp_path / "in"))
    out = tmp_path / "out"
    preprocess.run_preprocess(preprocess.PreprocessJob(anno_dir, IMAGE_DIR, str(out)), num_workers=1)
    for seqdir in preprocess.find_sequence_dirs(anno_dir):
        assert seqdir in jpre.find_sequence_dirs(anno_dir)
        for f in sorted(os.listdir(seqdir)):
            assert preprocess.parse_frame(os.path.join(seqdir, f)) == jpre.parse_frame(os.path.join(seqdir, f))
    for d in sorted(os.listdir(out)):
        for f in sorted(x[:-4] for x in os.listdir(out / d) if x.endswith(".txt")):
            a = preprocess.read_frame_record(str(out / d / f))
            b = jpre.read_frame_record(str(out / d / f))
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            assert a["gt"].dtype == np.float32


@pytest.mark.parametrize("min_length", [2, 3, 4])
def test_valid_sequences_and_batches_match_jax(tmp_path, min_length, monkeypatch):
    # relative paths: the train/val split reads a substring of the path
    monkeypatch.chdir(tmp_path)
    anno_dir, _ = write_synthetic_vid("in")
    preprocess.run_preprocess(preprocess.PreprocessJob(anno_dir, IMAGE_DIR, "out"), num_workers=1)
    got = sequences.get_valid_sequences("out", min_length)
    assert got == jseq.get_valid_sequences("out", min_length)
    _, train, val = got
    assert train and all("train" in s for s, _ in train) and all("val" in s for s, _ in val)
    assert all(len(frames) == min_length for _, frames in got[0])
    seqs = got[0]
    assert sequences.sevenbyseven_get_batch(0, 2, seqs) == jseq.sevenbyseven_get_batch(0, 2, seqs)


def test_sequence_outside_both_splits_raises(tmp_path):
    d = tmp_path / "seqs" / "neither_0"
    d.mkdir(parents=True)
    for i in range(3):
        (d / f"{i:06d}.txt").write_text("x")
    with pytest.raises(ValueError, match="train or val"):
        sequences.get_valid_sequences(str(tmp_path / "seqs"), 2)
