"""The port's sequence mining (data/mining.py) and pickle dataset
(data/pickle_dataset.py) against the JAX package's and the executed
reference's gen_sequences (ref_gen_sequences.pkl): the same pickles from
the same annotations."""

import os
import pickle

import numpy as np
import pytest
from fixture_params import seeded_mining_stats
from synthetic_vid import _OBJ, _XML

from ntm_tracker_tpu.data import mining as jmining
from ntm_tracker_tpu.data import pickle_dataset as jpickle
from ntm_tracker_tpu_torch.cli import main
from ntm_tracker_tpu_torch.data import mining, pickle_dataset

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
# 700x700 frames: pool5's priors are 100x100 cells, conv4_3's 25x25. A box
# on a cell matches its prior; the 600x600 box and the missing frame 5
# split a track's run.
CELL, BIG = [100, 200, 200, 300], [0, 0, 600, 600]
TRACKS = {
    "ILSVRC2015_train_00000000": [(0, {0: CELL, 1: [25, 25, 50, 50]}), (1, {0: CELL, 1: [25, 50, 50, 75]}),
                                  (2, {0: BIG, 1: [50, 50, 75, 75]}), (3, {0: CELL}), (4, {0: CELL}),
                                  (6, {0: CELL}), (7, {0: CELL})],
    "ILSVRC2015_train_00000001": [(t, {3: [200 + 2 * t, 100, 300 + 2 * t, 200]}) for t in range(6)],
}


def write_tree(root, images=False):
    """Annotations (and, with images, JPEG frames) of TRACKS; returns
    (annotation_dir, image_dir)."""
    anno_dir, image_dir = os.path.join(root, "Annotations"), os.path.join(root, "Data")
    rng = np.random.RandomState(0)
    for seqname, frames in TRACKS.items():
        for d in (anno_dir, image_dir):
            os.makedirs(os.path.join(d, "VID", "train", seqname))
        for idx, objs in frames:
            objects = "".join(_OBJ.format(tid=t, ymin=b[0], xmin=b[1], ymax=b[2], xmax=b[3])
                              for t, b in sorted(objs.items()))
            with open(os.path.join(anno_dir, "VID", "train", seqname, f"{idx:06d}.xml"), "w") as f:
                f.write(_XML.format(seqname=seqname, frame=idx, w=700, h=700, objects=objects))
            if images:
                from PIL import Image

                Image.fromarray((rng.rand(70, 70, 3) * 255).astype(np.uint8)).save(
                    os.path.join(image_dir, "VID", "train", seqname, f"{idx:06d}.JPEG"))
    return anno_dir, image_dir


def normalize(seqs):
    return [
        (seq_dir, obj, int(sid), int(length),
         [(path, tuple(float(v) for v in size), tuple(map(tuple, np.asarray(bbox, float))),
           [np.asarray(g, bool).tolist() for g in gts]) for path, size, bbox, gts in frames])
        for seq_dir, obj, sid, length, frames in seqs
    ]


def test_gen_sequences_matches_jax_and_the_reference():
    mine = mining.gen_sequences(seeded_mining_stats(), 0.5)
    assert normalize(mine) == normalize(jmining.gen_sequences(seeded_mining_stats(), 0.5))
    with open(os.path.join(FIXTURE_DIR, "ref_gen_sequences.pkl"), "rb") as f:
        ref = normalize(pickle.load(f))
    # the reference never flushes the trailing viable run; the port, like
    # the JAX package, keeps it
    assert len(mine) == len(ref) + 1 and normalize(mine)[:-1] == ref
    assert mine[-1][3] == len(mine[-1][4]) > 0


@pytest.mark.parametrize("input_size", [224, 128])
def test_layer_sizes_and_prior_maps_match_jax(input_size):
    sizes = mining.vgg_layer_sizes(input_size)
    assert sizes == jmining.vgg_layer_sizes(input_size)
    bbox = [(100.0, 50.0), (300.0, 200.0)]
    for a, b in zip(mining.prior_box_iou_maps(sizes, ["conv4_3", "pool5"], (640.0, 360.0), bbox),
                    jmining.prior_box_iou_maps(sizes, ["conv4_3", "pool5"], (640.0, 360.0), bbox)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("layers,workers", [("conv4_3", 1), ("pool5", 1), ("conv4_3,pool5", 1), ("pool5", 2)])
def test_mine_sequences_cli_writes_the_jax_pickle(tmp_path, layers, workers):
    anno_dir, image_dir = write_tree(str(tmp_path / "in"))
    port_pkl, jax_pkl = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    assert main(["--device", "cpu", "mine-sequences", "--image_dirs", image_dir, "--annotation_dirs", anno_dir,
                 "--output_pickle", port_pkl, "--num_workers", str(workers), "--layers", layers]) == 0
    jmining.mine_and_dump([image_dir], [anno_dir], out_path=jax_pkl, num_workers=1, layers=layers.split(","))
    with open(port_pkl, "rb") as a, open(jax_pkl, "rb") as b:
        port, ref = pickle.load(a), pickle.load(b)
    assert normalize(port) == normalize(ref)
    # the splits: pool5 keeps track 0's runs around the big box and the
    # gap, track 3 whole; conv4_3 keeps track 1
    assert sorted(s[3] for s in port) == {"conv4_3": [3], "pool5": [2, 2, 2, 6], "conv4_3,pool5": [2, 2, 2, 3, 6]}[layers]
    stats = mining.get_statistics([image_dir], [anno_dir])
    assert stats == jmining.get_statistics([image_dir], [anno_dir])


def test_pickle_dataset_readers_match_jax(tmp_path):
    anno_dir, image_dir = write_tree(str(tmp_path / "in"), images=True)
    pkl = str(tmp_path / "gen.pkl")
    mining.mine_and_dump([image_dir], [anno_dir], out_path=pkl, num_workers=1, layers=["pool5"])
    # the layers are this call's, not the last call's
    assert mining.mine_and_dump([image_dir], [anno_dir], out_path=str(tmp_path / "c43.pkl"), num_workers=1) != []
    seqs = pickle_dataset.load_generated_sequences(pkl, 2)
    assert normalize(seqs) == normalize(jpickle.load_generated_sequences(pkl, 2)) and len(seqs) == 4
    for fn, jfn in ((pickle_dataset.default_get_batch, jpickle.default_get_batch),
                    (pickle_dataset.active_resize_get_batch, jpickle.active_resize_get_batch)):
        names, arr, index = fn(0, 2, 2, seqs)
        jnames, jarr, jindex = jfn(0, 2, 2, seqs)
        assert names == jnames and index == jindex == 2
        np.testing.assert_array_equal(arr, jarr)
    images = pickle_dataset.load_wholeframe_batch(names, crop_size=32)
    np.testing.assert_array_equal(images, jpickle.load_wholeframe_batch(names, crop_size=32))
    assert images.shape == (4, 32, 32, 3) and images.dtype == np.float32
