"""Frozen-feature cache: the VGG conv4_3 tokens of every frame record,
computed once, so training runs only the memory core (counterpart of
ntm_tracker_tpu/data/feature_cache.py; `cache-features` +
`train-offsets --feature_cache`).

Layout, the JAX package's byte for byte: `<cache_dir>/<base|flip>/
<seq_basename>/<frame>.npy` (one [F, C] token array per frame record) plus
`<cache_dir>/<base|flip>/manifest.json` with a fingerprint of everything
the tokens depend on (VGG weights, crop/resize geometry, feature grid,
compute dtype). `flip/` holds the tokens of horizontally mirrored frames
for --reverse_image. A cache built by either package verifies and loads
in the other: the fingerprint hashes the VGG weights in the JAX package's
HWIO layout under its pytree key paths.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import Counter
from typing import Iterator, List, NamedTuple, Sequence

import numpy as np
import torch

CACHE_VERSION = 1
_MANIFEST = "manifest.json"


class TokenBatch(NamedTuple):
    features: np.ndarray   # [B*L, F, C] store_dtype tokens
    gts: np.ndarray        # [B*L, gt, gt] float32
    y_offsets: np.ndarray  # [B*L] float32
    x_offsets: np.ndarray  # [B*L] float32
    # raw log-scale targets (loader.record_log_scales; flip-invariant)
    scales: np.ndarray = None  # [B*L] float32


def dtype_name(dtype) -> str:
    """numpy's name of a compute dtype given as a torch or numpy dtype
    ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _jax_key_path(layer: str, leaf: str) -> str:
    """str() of the JAX key path of params[layer][leaf], which the JAX
    package's fingerprint hashes."""
    return f"(DictKey(key={layer!r}), DictKey(key={leaf!r}))"


def cache_fingerprint(cfg, vgg_params, flip: bool) -> str:
    """Hash of everything the cached tokens are a function of: the VGG
    weights, the crop/resize geometry, the feature grid and the compute
    dtype. A changed fingerprint means the cache is stale. The port's
    VGG weights (OIHW) are hashed as HWIO, as the JAX package holds them."""
    h = hashlib.sha256()
    h.update(
        (
            f"v{CACHE_VERSION};crop{cfg.data.crop_size};"
            f"resize{tuple(cfg.data.resize_hw)};flip{bool(flip)};"
            # fast_conv43 changes the route, not the values: not hashed
            f"pts{cfg.feature_points};F{cfg.num_features};"
            f"C{cfg.feature_depth};dtype{dtype_name(cfg.compute_dtype)}"
            # an int8-built cache must never serve exact-path training
            + (";int8" if getattr(cfg, "vgg_int8", False) else "")
        ).encode()
    )
    leaves = []
    for layer, p in vgg_params.items():
        for leaf, value in p.items():
            arr = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value, np.float32)
            if leaf == "weights":
                arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            leaves.append((_jax_key_path(layer, leaf), arr))
    for path, arr in sorted(leaves, key=lambda kv: kv[0]):
        h.update(path.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def _variant_dir(cache_dir: str, flip: bool) -> str:
    return os.path.join(cache_dir, "flip" if flip else "base")


def _frame_path(root: str, frame_record_path: str) -> str:
    seq = os.path.basename(os.path.dirname(frame_record_path))
    return os.path.join(root, seq, os.path.basename(frame_record_path) + ".npy")


def read_manifest(cache_dir: str, flip: bool = False) -> dict:
    path = os.path.join(_variant_dir(cache_dir, flip), _MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no feature cache manifest at {path}; build one with "
            "`cache-features`" + (" --reverse_image" if flip else "")
        )
    with open(path) as f:
        return json.load(f)


def verify_cache(cfg, cache_dir: str, flip: bool = False, vgg_params=None) -> dict:
    """Check the manifest against the config (and, when VGG params are at
    hand, the full fingerprint). Returns the manifest."""
    man = read_manifest(cache_dir, flip)
    if (man["num_features"], man["feature_depth"]) != (cfg.num_features, cfg.feature_depth):
        raise ValueError(
            f"feature cache {cache_dir} holds "
            f"[{man['num_features']},{man['feature_depth']}] tokens but the "
            f"config expects [{cfg.num_features},{cfg.feature_depth}]"
        )
    if vgg_params is not None:
        fp = cache_fingerprint(cfg, vgg_params, flip)
        if fp != man["fingerprint"]:
            raise ValueError(
                f"feature cache {cache_dir} is stale: fingerprint "
                f"{man['fingerprint']} != expected {fp} (VGG weights or "
                "crop/resize geometry changed — rebuild with cache-features)"
            )
    return man


def cache_frames(sequence_dirs: Sequence[str]) -> List[str]:
    """Every frame record under the sequence dirs, in cache order. Two dirs
    with one basename would share cache entries: refused."""
    basenames = [os.path.basename(os.path.normpath(s)) for s in sequence_dirs]
    dups = sorted(b for b, n in Counter(basenames).items() if n > 1)
    if dups:
        raise ValueError(
            f"sequence dirs with duplicate basenames would collide in the "
            f"cache layout: {dups} (cache entries are keyed by basename; "
            f"pass dirs with unique names or use separate cache_dirs)"
        )
    frames: List[str] = []
    for seqdir in sequence_dirs:
        names = sorted(x[:-4] for x in os.listdir(seqdir) if x.endswith(".txt"))
        frames += [os.path.join(seqdir, n) for n in names]
    if not frames:
        raise ValueError(f"no frame records under {sequence_dirs!r}")
    return frames


def build_feature_cache(
    cfg,
    vgg_params,
    sequence_dirs: Sequence[str],
    cache_dir: str,
    *,
    flip: bool = False,
    store_dtype: str = "float16",
    frames_per_batch: int = 256,
    gt_width: int = 8,
    decode_resize_hw=None,
    progress=None,
    mesh=None,
    device=None,
) -> dict:
    """Compute and store the tokens of every frame record under each
    sequence dir (all .txt frames, so the cache serves any
    sequence_length), `frames_per_batch` frames per VGG call on `device`
    (cuda unless the caller names another; the VGG params must be there).
    Returns the manifest dict. `mesh` (the JAX package's sharded build) is
    data parallelism, not ported (ROADMAP A7): it raises."""
    from ntm_tracker_tpu_torch.config import resolve_device
    from ntm_tracker_tpu_torch.data.image_ops import preprocess_frame
    from ntm_tracker_tpu_torch.data.loader import load_shared_frames
    from ntm_tracker_tpu_torch.train.experiments import frame_tokens

    if mesh is not None:
        raise NotImplementedError("mesh / --shard: a data-parallel cache build is not ported (ROADMAP.md, item A7)")
    if store_dtype not in ("float16", "float32"):
        raise ValueError(f"store_dtype must be float16/float32, got {store_dtype}")
    dev = resolve_device(device)
    d = cfg.data
    if decode_resize_hw is None:
        decode_resize_hw = tuple(d.resize_hw)
    frames = cache_frames(sequence_dirs)
    root = _variant_dir(cache_dir, flip)
    os.makedirs(root, exist_ok=True)
    np_dtype = np.dtype(store_dtype)
    done = 0
    for start in range(0, len(frames), frames_per_batch):
        chunk = frames[start:start + frames_per_batch]
        # each distinct frame crosses to the device once (a frame holds
        # a record of each of its objects)
        fb, index = load_shared_frames(chunk, gt_width, reverse_image=flip, decode_resize_hw=decode_resize_hw)
        with torch.no_grad():
            images = torch.as_tensor(fb.images, device=dev).float()[torch.as_tensor(index, device=dev)]
            crops = preprocess_frame(images, torch.as_tensor(fb.cropboxes, device=dev),
                                     resize_hw=d.resize_hw, crop_size=d.crop_size, do_resize=False)
            toks = frame_tokens(cfg, vgg_params, crops).float().cpu().numpy().astype(np_dtype)
        for i, frame in enumerate(chunk):
            out = _frame_path(root, frame)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, toks[i])
        done += len(chunk)
        if progress is not None:
            progress(done, len(frames))

    manifest = {
        "version": CACHE_VERSION,
        "fingerprint": cache_fingerprint(cfg, vgg_params, flip),
        "store_dtype": np_dtype.name,
        "num_features": cfg.num_features,
        "feature_depth": cfg.feature_depth,
        "flip": bool(flip),
        "num_frames": len(frames),
        "crop_size": d.crop_size,
        "resize_hw": list(d.resize_hw),
    }
    with open(os.path.join(root, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_token_batch(
    frame_paths: Sequence[str],
    gt_width: int,
    cache_dir: str,
    reverse_image: bool = False,
    use_native: bool = True,
    cropbox_grid: int = 8,
    bbox_grid: int = 6,
) -> TokenBatch:
    """A token batch: per-frame .npy tokens from the cache plus the
    gt/offset fields of the .txt/.bin records (no JPEG decode)."""
    from ntm_tracker_tpu_torch.data.loader import load_record_arrays, record_log_scales

    root = _variant_dir(cache_dir, reverse_image)
    feats = np.stack([np.load(_frame_path(root, p)) for p in frame_paths])
    _crops, offsets, gts, _paths, bboxes = load_record_arrays(frame_paths, gt_width, use_native)
    xo = -offsets[:, 1] if reverse_image else offsets[:, 1]
    return TokenBatch(
        features=feats,
        gts=gts,
        y_offsets=offsets[:, 0].copy(),
        x_offsets=np.asarray(xo),
        scales=record_log_scales(bboxes, cropbox_grid, bbox_grid),
    )


def token_batch_iterator(
    seqs,
    batch_size: int,
    cache_dir: str,
    gt_width: int = 8,
    shuffle: bool = True,
    seed: int = 42,
    reverse_image: bool = False,
    epochs: int = 1,
    cropbox_grid: int = 8,
    bbox_grid: int = 6,
) -> Iterator[TokenBatch]:
    """loader.batch_iterator's twin for cached tokens: the same epochs and
    shuffle, no image work."""
    from ntm_tracker_tpu_torch.data.loader import epoch_batches

    for frame_names in epoch_batches(seqs, batch_size, shuffle, seed, epochs):
        yield load_token_batch(frame_names, gt_width, cache_dir, reverse_image=reverse_image,
                               cropbox_grid=cropbox_grid, bbox_grid=bbox_grid)
