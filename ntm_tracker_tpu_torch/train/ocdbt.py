"""A read-only OCDBT key-value store: the on-disk database that tensorstore
writes for the JAX package's orbax checkpoints (`use_ocdbt`, the
`<step>/default/` directory; train/orbax_ckpt.py reads the arrays in it).

Written from the format; it imports no tensorstore. Every file of the
format is

    magic uint32be | length uint64le (the whole file or node) |
    format version varint (0) | compression varint (0 none, 1 zstd) |
    body (one zstd frame when compressed) | crc32c uint32le of all before

The manifest (`manifest.ocdbt`, magic 0x0cdb3a2a) holds the config, a
data-file table and the version tree: the newest versions inline, older
ones in version-tree nodes, which the reader reads past: it takes the
newest. Each version names the root of a B+tree (nodes: magic 0x0cdb20de)
by a reference (data file, offset, length). A node holds its own data-file table and its entries column by
column: each column is one varint per entry, keys are prefix-compressed,
and a child's keys are relative to its parent's key prefix. A leaf entry's
value sits inline in the node or in a data file (offset, length). A data
file is named by (base path, relative path), the base path relative to that
of the node that names it, so the root database's references into
`ocdbt.process_0/d/` resolve.

Only the byte ranges named by references are read; decoded nodes are kept
for the reader's life. Anything the reader does not know raises
OcdbtError and names the field.
"""

from __future__ import annotations

import bisect
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

from ntm_tracker_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
MISSING = 2**64 - 1  # the offset and length of an empty version's root
_MIN_FILE = 12 + 2 + 4  # magic, length, version, compression, checksum


class OcdbtError(ValueError):
    """A database the reader cannot read: a field it does not know, a bad
    checksum, a reference outside its file."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the format's footers carry it."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body; `where` names it in errors."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def _need(self, n: int, field: str):
        if self.pos + n > len(self.data):
            raise OcdbtError(f"ocdbt: {self.where} ends inside {field} (at byte {self.pos} of {len(self.data)})")

    def byte(self, field: str) -> int:
        self._need(1, field)
        self.pos += 1
        return self.data[self.pos - 1]

    def bytes(self, n: int, field: str) -> bytes:
        self._need(n, field)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def varint(self, field: str) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte(field)
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OcdbtError(f"ocdbt: {self.where}: {field} is a varint longer than 64 bits")

    def varints(self, n: int, field: str) -> List[int]:
        return [self.varint(field) for _ in range(n)]

    def int32le(self, field: str) -> int:
        return struct.unpack("<i", self.bytes(4, field))[0]

    def uint64le(self, field: str) -> int:
        return struct.unpack("<Q", self.bytes(8, field))[0]

    def end(self):
        if self.pos != len(self.data):
            raise OcdbtError(f"ocdbt: {len(self.data) - self.pos} bytes follow the end of {self.where}")


class DataFileId(NamedTuple):
    base_path: str
    relative_path: str

    @property
    def path(self) -> str:
        return self.base_path + self.relative_path


class Ref(NamedTuple):
    """A byte range of a data file: a node, or a value stored out of line."""

    file: DataFileId
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Ref]  # None: the empty tree
    num_keys: int
    commit_time: int


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: str  # "none" or "zstd"
    zstd_level: Optional[int]


class Node(NamedTuple):
    height: int
    keys: List[bytes]  # full keys: the parent's prefix included
    children: List[Tuple[Ref, bytes]]  # interior: (node, the child's key prefix)
    values: List[object]  # leaf: bytes inline, or a Ref


def _decode_file(data: bytes, magic: int, what: str, max_size: int) -> bytes:
    """The body of a manifest or a node (`what` names it): the header checked,
    the checksum checked, zstd decoded."""
    if len(data) < _MIN_FILE:
        raise OcdbtError(f"ocdbt: {what} has {len(data)} bytes, too few for a header and a checksum")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"ocdbt: {what} has magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"ocdbt: {what} states length {length}, {len(data)} bytes were read")
    crc = struct.unpack("<I", data[-4:])[0]
    if crc32c(data[:-4]) != crc:
        raise OcdbtError(f"ocdbt: {what} fails its crc32c checksum (stored {crc:#010x})")
    head = _Reader(data[12:-4], what)
    version = head.varint("the format version")
    if version != FORMAT_VERSION:
        raise OcdbtError(f"ocdbt: {what} has format version {version}; this reader knows {FORMAT_VERSION}")
    compression = head.varint("the compression format")
    rest = data[12 + head.pos:-4]
    if compression == 0:
        return rest
    if compression == 1:
        return zstd.decompress(rest, where=what, max_size=max_size)
    raise OcdbtError(f"ocdbt: {what} has compression format {compression}; this reader knows 0 (none) and 1 (zstd)")


def _prefix_coded(r: _Reader, prefix: List[int], suffix: List[int], what: str) -> List[bytes]:
    """Strings stored as (length shared with the one before, the rest)."""
    out, prev = [], b""
    for i, (p, n) in enumerate(zip(prefix, suffix)):
        if p > len(prev):
            raise OcdbtError(f"ocdbt: {r.where}: {what} {i} shares {p} bytes with the one before, of {len(prev)}")
        prev = prev[:p] + r.bytes(n, what)
        out.append(prev)
    return out


def _data_file_table(r: _Reader, transitive: str) -> List[DataFileId]:
    """The data files a manifest or node names, their base paths prefixed
    with `transitive`, the base path of what holds the table."""
    n = r.varint("the data-file count")
    prefix = [0] + r.varints(max(n - 1, 0), "a data-file path's prefix length")
    suffix = r.varints(n, "a data-file path's suffix length")
    base = r.varints(n, "a data-file base-path length")
    files = []
    for i, (path, b) in enumerate(zip(_prefix_coded(r, prefix, suffix, "a data-file path"), base)):
        if b > len(path):
            raise OcdbtError(f"ocdbt: {r.where}: data file {i}'s base path {b} exceeds its path")
        text = path.decode()
        files.append(DataFileId(transitive + text[:b], text[b:]))
    return files


def _refs(r: _Reader, n: int, files: List[DataFileId], lengths: Optional[List[int]] = None,
          allow_missing: bool = False) -> List[Optional[Ref]]:
    """n references as columns: data-file indices, offsets, then lengths
    (unless the caller has them already)."""
    ids = r.varints(n, "a data-file index")
    offsets = r.varints(n, "an offset")
    if lengths is None:
        lengths = r.varints(n, "a length")
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if allow_missing and o == MISSING and ln == MISSING:
            out.append(None)
            continue
        if i >= len(files):
            raise OcdbtError(f"ocdbt: {r.where}: data-file index {i} outside its table of {len(files)}")
        out.append(Ref(files[i], o, ln))
    return out


def _versions(r: _Reader, n: int, files: List[DataFileId]) -> List[Version]:
    gens = r.varints(n, "a generation number")
    heights = [r.byte("a root height") for _ in range(n)]
    roots = _refs(r, n, files, allow_missing=True)
    num_keys = r.varints(n, "a key count")
    r.varints(n, "a tree's byte count")
    r.varints(n, "a tree's indirect value bytes")
    times = [r.uint64le("a commit time") for _ in range(n)]
    return [Version(*v) for v in zip(gens, heights, roots, num_keys, times)]


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """n prefix-compressed keys (relative to the node's prefix) and, for an
    interior node, each child's common-prefix length."""
    prefix = [0] + r.varints(max(n - 1, 0), "a key's prefix length")
    suffix = r.varints(n, "a key's suffix length")
    common = r.varints(n, "a subtree's common-prefix length") if interior else []
    return _prefix_coded(r, prefix, suffix, "a key"), common


def _skip_version_node_refs(r: _Reader, n: int, files: List[DataFileId]) -> None:
    """The manifest's n references to version-tree nodes, as columns: the
    last generation of each, the node, its generation count, commit time and
    height. Read past: the newest version is always inline."""
    r.varints(n, "a version node's generation number")
    _refs(r, n, files)
    r.varints(n, "a version node's generation count")
    for _ in range(n):
        r.uint64le("a version node's commit time")
    for _ in range(n):
        r.byte("a version node's height")


class OcdbtReader:
    """The newest generation of the OCDBT database in `directory` (the one
    holding `manifest.ocdbt`): `list()` its keys, `read(key)` a value."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        path = os.path.join(self.directory, "manifest.ocdbt")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise OcdbtError(f"ocdbt: no manifest.ocdbt in {self.directory}") from None
        r = _Reader(_decode_file(data, MANIFEST_MAGIC, path, 1 << 30), path)
        self.config = self._config(r)
        files = _data_file_table(r, "")
        inline = _versions(r, r.varint("the version count"), files)
        _skip_version_node_refs(r, r.varint("the version-node count"), files)
        r.end()
        if not inline:
            raise OcdbtError(f"ocdbt: {path} holds no inline version")
        self.version = max(inline, key=lambda v: v.generation)
        self._nodes: Dict[Tuple[str, int], Node] = {}

    def _config(self, r: _Reader) -> Config:
        uuid = r.bytes(16, "the database uuid")
        kind = r.varint("the manifest kind")
        if kind != 0:
            raise OcdbtError(f"ocdbt: {r.where}: manifest kind {kind} (numbered manifests); this reader knows 0 (single)")
        inline_max = r.varint("max_inline_value_bytes")
        node_max = r.varint("max_decoded_node_bytes")
        arity = r.byte("version_tree_arity_log2")
        method = r.varint("the compression method")
        if method == 0:
            return Config(uuid, kind, inline_max, node_max, arity, "none", None)
        if method == 1:
            return Config(uuid, kind, inline_max, node_max, arity, "zstd", r.int32le("the zstd level"))
        raise OcdbtError(f"ocdbt: {r.where}: compression method {method}; this reader knows 0 (none) and 1 (zstd)")

    # -- byte ranges ---------------------------------------------------------

    def _read_range(self, ref: Ref) -> bytes:
        rel = os.path.normpath(ref.file.path)
        if os.path.isabs(rel) or rel.split(os.sep)[0] == "..":
            raise OcdbtError(f"ocdbt: a reference names {ref.file.path!r}, outside {self.directory}")
        path = os.path.join(self.directory, rel)
        try:
            with open(path, "rb") as f:
                f.seek(ref.offset)
                data = f.read(ref.length)
        except FileNotFoundError:
            raise OcdbtError(f"ocdbt: the data file {path} is missing") from None
        if len(data) != ref.length:
            raise OcdbtError(f"ocdbt: {path} is truncated: {ref.length} bytes at offset {ref.offset} "
                             f"named, {len(data)} there ({os.path.getsize(path)} bytes in the file)")
        return data

    def _where(self, ref: Ref) -> str:
        return f"{os.path.join(self.directory, ref.file.path)} at offset {ref.offset}"

    # -- the B+tree ----------------------------------------------------------

    def _node(self, ref: Ref, height: int, prefix: bytes) -> Node:
        cache_key = (ref.file.path, ref.offset)
        node = self._nodes.get(cache_key)
        if node is not None:
            return node
        what = f"the B+tree node in {self._where(ref)}"
        r = _Reader(_decode_file(self._read_range(ref), BTREE_NODE_MAGIC, what,
                                 self.config.max_decoded_node_bytes), what)
        got = r.byte("the node height")
        if got != height:
            raise OcdbtError(f"ocdbt: {what}: height {got}, its reference says {height}")
        files = _data_file_table(r, ref.file.base_path)
        n = r.varint("the entry count")
        if n == 0:
            raise OcdbtError(f"ocdbt: {what} has no entries")
        keys, common = _keys(r, n, interior=height > 0)
        full = [prefix + k for k in keys]
        if height > 0:
            children = _refs(r, n, files)
            r.varints(n, "a subtree's key count")
            r.varints(n, "a subtree's byte count")
            r.varints(n, "a subtree's indirect value bytes")
            r.end()
            node = Node(height, full, [(c, prefix + k[:p]) for c, k, p in zip(children, keys, common)], [])
        else:
            lengths = r.varints(n, "a value length")
            kinds = r.varints(n, "a value kind")
            if any(k not in (0, 1) for k in kinds):
                raise OcdbtError(f"ocdbt: {what}: value kind {max(kinds)}; this reader knows 0 (inline), 1 (indirect)")
            out_of_line = [i for i, k in enumerate(kinds) if k == 1]
            refs = iter(_refs(r, len(out_of_line), files, [lengths[i] for i in out_of_line]))
            values = [next(refs) if k == 1 else r.bytes(ln, "an inline value") for k, ln in zip(kinds, lengths)]
            r.end()
            node = Node(0, full, [], values)
        self._nodes[cache_key] = node
        return node

    def _root(self) -> Optional[Node]:
        v = self.version
        return None if v.root is None else self._node(v.root, v.root_height, b"")

    @property
    def height(self) -> int:
        """The root's height: 0 for a tree that is one leaf."""
        return self.version.root_height

    def list(self) -> List[str]:
        """Every key of the newest generation, sorted."""
        out: List[str] = []

        def walk(node: Node):
            if node.height == 0:
                out.extend(k.decode() for k in node.keys)
                return
            for child, child_prefix in node.children:
                walk(self._node(child, node.height - 1, child_prefix))

        root = self._root()
        if root is not None:
            walk(root)
        return out

    def read(self, key: str) -> bytes:
        """The value of `key`; KeyError when the newest generation lacks it."""
        want = key.encode()
        node = self._root()
        while node is not None and node.height > 0:
            i = bisect.bisect_right(node.keys, want) - 1
            if i < 0:
                node = None
                break
            child, child_prefix = node.children[i]
            node = self._node(child, node.height - 1, child_prefix)
        if node is not None:
            i = bisect.bisect_left(node.keys, want)
            if i < len(node.keys) and node.keys[i] == want:
                value = node.values[i]
                return self._read_range(value) if isinstance(value, Ref) else value
        raise KeyError(f"ocdbt: no key {key!r} in {self.directory}")
