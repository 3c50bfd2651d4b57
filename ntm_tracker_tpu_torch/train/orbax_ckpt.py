"""Reading the JAX package's orbax checkpoints: zarr v2 arrays in an OCDBT
database, and the tree that orbax's metadata describes (counterpart of the
restore half of ntm_tracker_tpu/train/harness.py's CheckpointManager,
which saves with `ocp.args.StandardSave`).

A step directory of an orbax CheckpointManager holds

    _CHECKPOINT_METADATA         JSON: item_handlers {"default": ...StandardCheckpointHandler}
    default/_METADATA            JSON: tree_metadata, use_ocdbt, use_zarr3
    default/manifest.ocdbt, default/d/, default/ocdbt.process_<i>/
                                 the OCDBT database (train/ocdbt.py)

and in the database, for each leaf named by its key path joined with ".",
`<name>/.zarray` (zarr v2 metadata, JSON) and one key a chunk,
`<name>/<chunk index joined by the dimension separator>` ("0" for a 0-d
array), each chunk one zstd frame. `_METADATA.tree_metadata` maps each
leaf's key tuple to its keys' types (1: a sequence index, 2: a dict key)
and its value type.

The tree comes back as orbax's raw restore gives it: dicts for dict keys
(a NamedTuple was saved as a dict of its fields), lists for sequences,
CPU tensors for arrays (bfloat16 included), a Python number for a
`scalar`, None for an empty leaf (the optax chain's EmptyState), and an
empty dict / list / tuple where one was saved. No writer: the port saves
its own `.pt` files (train/harness.py).
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, List

import numpy as np
import torch

from ntm_tracker_tpu_torch.train.ocdbt import OcdbtReader
from ntm_tracker_tpu_torch.utils import zstd

CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
ITEM = "default"
# StandardCheckpointHandler (ocp.args.StandardSave, what the JAX package's
# harness writes) wraps PyTreeCheckpointHandler; both write this layout
HANDLERS = ("StandardCheckpointHandler", "PyTreeCheckpointHandler")
# zarr v2 dtype -> numpy dtype of the stored bytes (bfloat16 as int16, viewed
# as torch.bfloat16 afterwards)
DTYPES = {"<f2": np.float16, "<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64,
          "|b1": np.bool_, "bfloat16": np.int16}
SEQUENCE, DICT_KEY = 1, 2
EMPTY_VALUES = {"None": lambda: None, "NamedTuple": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
ARRAY_VALUES = ("np.ndarray", "jax.Array")


class OrbaxFormatError(ValueError):
    """A step directory that is not a checkpoint the JAX package's harness
    writes, or whose arrays are damaged."""


def is_orbax_step(path: str) -> bool:
    """Whether `path` is an orbax step directory (it holds _CHECKPOINT_METADATA)."""
    return os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))


def _json(path: str) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise OrbaxFormatError(f"orbax: {path} is missing") from None
    except json.JSONDecodeError as e:
        raise OrbaxFormatError(f"orbax: {path} is not JSON: {e}") from None


def read_array(store: OcdbtReader, name: str) -> torch.Tensor:
    """The zarr v2 array `name` of an OCDBT store, as a CPU tensor."""
    try:
        meta = json.loads(store.read(f"{name}/.zarray"))
    except KeyError:
        raise OrbaxFormatError(f"orbax: array {name}: no {name}/.zarray in {store.directory}") from None
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"orbax: array {name}: zarr_format {meta.get('zarr_format')!r}, this reader knows 2")
    dtype_name = meta.get("dtype")
    if dtype_name not in DTYPES:
        raise OrbaxFormatError(f"orbax: array {name}: dtype {dtype_name!r}; this reader knows {sorted(DTYPES)}")
    if meta.get("filters") is not None:
        raise OrbaxFormatError(f"orbax: array {name}: filters {meta['filters']!r}; this reader knows none")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"orbax: array {name}: compressor {compressor!r}; this reader knows zstd and none")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"orbax: array {name}: order {order!r}; this reader knows C and F")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise OrbaxFormatError(f"orbax: array {name}: dimension_separator {sep!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OrbaxFormatError(f"orbax: array {name}: chunks {list(chunks)} do not fit shape {list(shape)}")
    dtype = np.dtype(DTYPES[dtype_name])
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    out = np.empty(shape, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            raw = store.read(key)
        except KeyError:
            raise OrbaxFormatError(f"orbax: array {name}: chunk {key} is missing") from None
        if compressor is not None:
            raw = zstd.decompress(raw, where=f"array {name} chunk {key}", max_size=chunk_bytes)
        if len(raw) != chunk_bytes:
            raise OrbaxFormatError(f"orbax: array {name}: chunk {key} holds {len(raw)} bytes, "
                                   f"a {list(chunks)} chunk of {dtype_name} is {chunk_bytes}")
        block = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    tensor = torch.from_numpy(out)
    return tensor.view(torch.bfloat16) if dtype_name == "bfloat16" else tensor


def _leaf(store: OcdbtReader, name: str, value_type: str) -> Any:
    if value_type in EMPTY_VALUES:
        return EMPTY_VALUES[value_type]()
    if value_type in ARRAY_VALUES:
        return read_array(store, name)
    if value_type == "scalar":
        return read_array(store, name).item()
    raise OrbaxFormatError(f"orbax: leaf {name}: value_type {value_type!r}; this reader knows "
                           f"{sorted(ARRAY_VALUES + ('scalar',) + tuple(EMPTY_VALUES))}")


class _Branch(dict):
    """An inner node of the tree while it is read: {key: (key_type, child)}."""


def _build(node: _Branch, where: str) -> Any:
    """Nested _Branch nodes -> dicts and lists."""
    types = {t for t, _ in node.values()}
    if len(types) > 1:
        raise OrbaxFormatError(f"orbax: {where or 'the root'} mixes key types {sorted(types)}")
    kind = types.pop()
    children = {k: _build(c, f"{where}.{k}" if where else k) if isinstance(c, _Branch) else c
                for k, (_, c) in node.items()}
    if kind == DICT_KEY:
        return children
    if kind == SEQUENCE:
        if sorted(children, key=int) != [str(i) for i in range(len(children))]:
            raise OrbaxFormatError(f"orbax: {where or 'the root'}: sequence indices {sorted(children)} "
                                   f"are not 0..{len(children) - 1}")
        return [children[str(i)] for i in range(len(children))]
    raise OrbaxFormatError(f"orbax: {where or 'the root'}: key_type {kind}; this reader knows 1 (sequence), 2 (dict)")


def read_step(step_dir: str) -> Any:
    """The tree saved in an orbax step directory (see the module docstring)."""
    step_dir = os.path.abspath(step_dir)
    handlers = _json(os.path.join(step_dir, CHECKPOINT_METADATA)).get("item_handlers")
    handler = handlers.get(ITEM) if isinstance(handlers, dict) else handlers
    if not isinstance(handler, str) or not handler.endswith(HANDLERS):
        raise OrbaxFormatError(f"orbax: {step_dir}: item handlers {handlers!r}; this reader knows the item "
                               f"{ITEM!r} written by {' or '.join(HANDLERS)}")
    item = os.path.join(step_dir, ITEM)
    meta = _json(os.path.join(item, "_METADATA"))
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"orbax: {item} is written with use_zarr3=True (zarr v3 arrays); "
                                  "this reader knows zarr v2, which the JAX package's harness writes")
    if not meta.get("use_ocdbt", False):
        raise NotImplementedError(f"orbax: {item} is written with use_ocdbt=False (a tensorstore directory "
                                  "a leaf); this reader knows the OCDBT database, which the JAX package's "
                                  "harness writes")
    tree_metadata = meta.get("tree_metadata")
    if not isinstance(tree_metadata, dict) or not tree_metadata:
        raise OrbaxFormatError(f"orbax: {item}/_METADATA has no tree_metadata")
    store = OcdbtReader(item)
    root = _Branch()
    for entry in tree_metadata.values():
        keys: List[dict] = entry["key_metadata"]
        name = ".".join(str(k["key"]) for k in keys)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(str(k["key"]), (k["key_type"], _Branch()))[1]
        node[str(keys[-1]["key"])] = (keys[-1]["key_type"], _leaf(store, name, entry["value_metadata"]["value_type"]))
    return _build(root, "")
