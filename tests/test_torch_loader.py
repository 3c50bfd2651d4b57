"""The port's data loader (data/loader.py) and native readers
(native/record_loader.cpp, native/jpeg_pipeline.cpp, built with g++ into
ntm_tracker_tpu_torch/_build/) against the JAX package's: the same arrays
and the same frame order; a prefetch worker's error reaches the consumer."""

import os
import threading

import numpy as np
import pytest

from ntm_tracker_tpu.data import loader as jloader
from ntm_tracker_tpu.data import native_jpeg as jnative_jpeg
from ntm_tracker_tpu.data import native_loader as jnative_loader
from ntm_tracker_tpu.data.preprocess import read_frame_record as jread_frame_record
from ntm_tracker_tpu_torch import _build
from ntm_tracker_tpu_torch.data import loader, native_jpeg, native_loader
from ntm_tracker_tpu_torch.data.preprocess import PreprocessJob, run_preprocess
from ntm_tracker_tpu_torch.data.sequences import get_valid_sequences
from ntm_tracker_tpu_torch.data.synthetic_vid import write_vid_tree

SEQS = [
    ("ILSVRC2015_train_00000000", "train", (160, 96), 6),
    ("ILSVRC2015_train_00000001", "train", (160, 96), 6),
    ("ILSVRC2015_train_00000002", "train", (160, 96), 6),
    ("ILSVRC2015_val_00000000", "val", (80, 48), 6),
]
HW = (72, 120)  # the host resize, small: the arrays' values, not their size, are under test


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """(cropped dir, train seqs, val seqs), paths relative to the module's
    directory: the train/val split reads a substring of the path."""
    root = str(tmp_path_factory.mktemp("vid"))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        anno, img = write_vid_tree(".", seed=5, sequences=SEQS)
        run_preprocess(PreprocessJob(anno, img, "cropped"), num_workers=1)
        _, train, val = get_valid_sequences("cropped", 4)
    finally:
        os.chdir(cwd)
    return root, train, val


@pytest.fixture
def in_dataset(dataset, monkeypatch):
    monkeypatch.chdir(dataset[0])
    return dataset


def frame_paths(seqs):
    return [os.path.join(s, f) for s, frames in seqs for f in frames]


def assert_same_batch(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("reverse_image", [False, True])
@pytest.mark.parametrize("resize_hw", [HW, (720, 1280), None], ids=["host", "host720", "device"])
def test_load_frame_batch_matches_jax(in_dataset, reverse_image, resize_hw):
    _, train, _ = in_dataset
    paths = frame_paths(train[:1])
    kw = dict(gt_width=8, reverse_image=reverse_image, decode_resize_hw=resize_hw)
    if reverse_image and resize_hw is None:
        for fn in (loader.load_frame_batch, jloader.load_frame_batch):
            with pytest.raises(ValueError, match="flip-equivariant"):
                fn(paths, **kw)
        return
    got, ref = loader.load_frame_batch(paths, **kw), jloader.load_frame_batch(paths, **kw)
    assert_same_batch(got, ref)
    assert got.images.dtype == (np.uint8 if resize_hw is None else np.float32)


@pytest.mark.parametrize("shuffle,epochs,batch", [(True, 2, 1), (True, 3, 2), (False, 1, 2)])
def test_batch_iterator_same_order_and_arrays(in_dataset, shuffle, epochs, batch):
    _, train, _ = in_dataset
    kw = dict(gt_width=8, shuffle=shuffle, seed=11, epochs=epochs, decode_resize_hw=HW)
    got = list(loader.batch_iterator(train, batch, **kw))
    ref = list(jloader.batch_iterator(train, batch, **kw))
    assert len(got) == len(ref) == epochs * (len(train) // batch)
    for a, b in zip(got, ref):
        assert_same_batch(a, b)


def test_mixed_sizes_need_host_resize(in_dataset):
    _, train, val = in_dataset
    seqs = [train[0], val[0]]
    with pytest.raises(ValueError, match="uniform frame sizes"):
        list(loader.batch_iterator(seqs, 2, shuffle=False, decode_resize_hw=None))
    # the host resize takes them
    assert next(loader.batch_iterator(seqs, 2, shuffle=False, decode_resize_hw=HW)).images.shape[1:3] == HW


def test_native_record_loader_matches_jax_and_python(in_dataset):
    _, train, val = in_dataset
    paths = frame_paths(train + val)
    got = native_loader.load_records_native(paths, gt_width=8)
    ref = jnative_loader.load_records_native(paths, gt_width=8)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == ref[4]
    crops, bboxes, offsets, gts, img_paths = got
    for i, p in enumerate(paths):
        rec = jread_frame_record(p)
        np.testing.assert_allclose(crops[i], rec["cropbox"], rtol=1e-6)
        np.testing.assert_allclose(bboxes[i], rec["bbox"], rtol=1e-6)
        np.testing.assert_allclose(offsets[i], [rec["y_offset"], rec["x_offset"]], rtol=1e-6)
        np.testing.assert_array_equal(gts[i], rec["gt"])
        assert img_paths[i] == rec["image_path"]
    with pytest.raises(IOError, match="does_not_exist"):
        native_loader.load_records_native([paths[0], "does_not_exist"], gt_width=8)


def test_python_and_native_record_routes_agree(in_dataset):
    _, train, _ = in_dataset
    paths = frame_paths(train[:2])
    loader.reset_route_counts()
    native = loader.load_record_arrays(paths, 8, use_native=True)
    python = loader.load_record_arrays(paths, 8, use_native=False)
    assert loader.RECORD_ROUTES == {"native": 1, "python": 1}
    for a, b in zip(native, python):
        if isinstance(a, list):
            assert a == b
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_array_equal(loader.record_log_scales(native[4]), jloader.record_log_scales(native[4]))


@pytest.mark.parametrize("out_hw", [(40, 56), (96, 160), (720, 1280)])
def test_native_jpeg_matches_jax_and_pil(in_dataset, out_hw):
    _, train, val = in_dataset
    imgs = [jread_frame_record(p)["image_path"] for p in frame_paths([train[0], val[0]])[::3]]
    got = native_jpeg.decode_resize_batch_native(imgs, out_hw, num_threads=2)
    np.testing.assert_array_equal(got, jnative_jpeg.decode_resize_batch_native(imgs, out_hw, num_threads=2))
    for i, p in enumerate(imgs):
        pil = loader._decode_image(p, out_hw)
        np.testing.assert_array_equal(pil, jloader._decode_image(p, out_hw))
        # libjpeg and PIL's IDCT agree to a level; the resize is the same float32 math
        np.testing.assert_allclose(got[i], pil, atol=1.0)
        assert float(np.abs(got[i] - pil).mean()) < 0.05


def test_decode_routes_are_counted(in_dataset, tmp_path):
    _, train, _ = in_dataset
    paths = frame_paths(train[:1])
    loader.reset_route_counts()
    loader.load_frame_batch(paths, decode_resize_hw=HW)       # native: a batch, resized on the host
    loader.load_frame_batch(paths, decode_resize_hw=None)     # uint8 frames: PIL
    assert loader.DECODE_ROUTES["native"]["batches"] == 1 and loader.DECODE_ROUTES["native"]["frames"] == 4
    assert loader.DECODE_ROUTES["pil"]["batches"] == 1 and loader.DECODE_ROUTES["pil"]["frames"] == 4
    # a file libjpeg refuses goes to PIL, which raises for it
    bad = tmp_path / "broken.JPEG"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(RuntimeError):
        native_jpeg.decode_resize_batch_native([str(bad), str(bad)], HW)
    with pytest.raises(OSError):
        loader._decode_images_parallel([str(bad), str(bad)], HW)


def test_host_libraries_build_into_the_port_tree():
    for name in ("record_loader", "jpeg_pipeline"):
        path = _build.library_path(name)
        assert path.parent.parent == _build.BUILD_ROOT and path.name == f"lib{name}.so"
        assert _build.build(name) == path and path.exists()
    assert _build.library_path("record_loader").parent != _build.library_path("jpeg_pipeline").parent
    assert (_build.NATIVE / "record_loader.cpp").read_bytes() == (
        _build.NATIVE.parents[1] / "ntm_tracker_tpu" / "native" / "record_loader.cpp").read_bytes()


def test_prefetch_surfaces_worker_errors_and_applies_device_put():
    def broken():
        yield 1
        yield 2
        raise IOError("corrupt record")

    it = loader.PrefetchIterator(broken(), prefetch=1, device_put=lambda x: x * 10)
    assert next(it) == 10 and next(it) == 20
    with pytest.raises(IOError, match="corrupt record"):
        next(it)
    ref = jloader.PrefetchIterator(broken(), prefetch=1)
    assert [next(ref), next(ref)] == [1, 2]
    with pytest.raises(IOError, match="corrupt record"):
        next(ref)


def test_prefetch_ends_cleanly_and_counts_waiting():
    gate = threading.Event()

    def slow():
        gate.wait(5)
        yield "a"

    it = loader.PrefetchIterator(slow())
    threading.Timer(0.5, gate.set).start()
    assert list(it) == ["a"]
    assert len(it.waits) == 2 and it.waits[0] >= 0.25


@pytest.mark.parametrize("resize_hw", [HW, None], ids=["host", "device"])
def test_shared_frames_decode_once_to_the_same_arrays(in_dataset, resize_hw):
    """Records of several objects in one frame share its JPEG: decoded once,
    the batch the JAX package's, which decodes it once a record."""
    _, train, _ = in_dataset
    imgs = [jread_frame_record(p)["image_path"] for p in frame_paths(train[:1])]
    paths = [imgs[0], imgs[1], imgs[0], imgs[0], imgs[2]]
    loader.reset_route_counts()
    got = loader._decode_images_parallel(paths, resize_hw)
    np.testing.assert_array_equal(got, jloader._decode_images_parallel(paths, resize_hw))
    route = "native" if resize_hw else "pil"
    assert loader.DECODE_ROUTES[route]["frames"] == 3 and got.shape[0] == 5


@pytest.mark.parametrize("reverse_image", [False, True])
def test_shared_frames_of_a_multi_object_tree(tmp_path, monkeypatch, reverse_image):
    """Three tracks in each frame: load_shared_frames' distinct frames,
    indexed by its rows, are load_frame_batch's, and the JAX package's."""
    monkeypatch.chdir(tmp_path)
    anno, img = write_vid_tree(".", seed=9, sequences=[("ILSVRC2015_train_00000000", "train", (160, 96), 5, 3)])
    run_preprocess(PreprocessJob(anno, img, "cropped"), num_workers=1)
    _, train, _ = get_valid_sequences("cropped", 4)
    assert len(train) == 3
    paths = frame_paths(train)
    shared, index = loader.load_shared_frames(paths, reverse_image=reverse_image, decode_resize_hw=HW)
    assert len(shared.images) == 4 and len(index) == 12
    full = loader.load_frame_batch(paths, reverse_image=reverse_image, decode_resize_hw=HW)
    assert_same_batch(shared._replace(images=shared.images[index]), full)
    assert_same_batch(full, jloader.load_frame_batch(paths, reverse_image=reverse_image, decode_resize_hw=HW))
