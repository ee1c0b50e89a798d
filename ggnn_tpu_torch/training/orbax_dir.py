"""The on-disk format of the JAX package's Orbax directory checkpoints,
read and written without orbax, tensorstore or zstandard.

`ggnn_tpu/training/checkpoint.py` saves a flat {sanitized name: array}
tree through `orbax.checkpoint.StandardCheckpointer`. The directory it
writes holds:

  _METADATA              JSON: "tree_metadata" keyed by tuple reprs such
                         as "('params.graph.w',)", "use_ocdbt": true,
                         "use_zarr3": false
  _CHECKPOINT_METADATA   JSON naming the StandardCheckpointHandler
  ggnn_meta.json         the package's own sidecar (training/checkpoint.py)
  manifest.ocdbt, d/...  one OCDBT key-value database (tensorstore's
                         "ocdbt" kvstore), holding for each name a zarr v2
                         array: "<name>/.zarray" (JSON) and its chunks
                         "<name>/0.0" ..., each chunk a zstd frame

and, as Orbax writes them, `ocdbt.process_<i>/` subdatabases whose data
files the root database's B-tree points into.

OCDBT, as read here: a manifest and B-tree nodes, each file framed as
  magic (uint32 big-endian: 0x0cdb3a2a manifest, 0x0cdb20de node),
  length (uint64 little-endian, the whole file), version (varint, 0),
  compression (varint: 0 none, 1 zstd), the body, crc32c (uint32 LE) of
  everything before it.
The manifest's body is the database's config, then the inline version
tree: a table of data files and, a column each, the versions'
generation, root height, root node (data file, offset, length) and
statistics. A node's body is its height, its own table of data files and
its entries, column by column: keys prefix-compressed against the entry
before, and for an interior node each child's common key prefix (the
keys below it drop that prefix) and location; for a leaf, each value's
length and kind (inline, or indirect at an offset of a data file). A
data file's path is its table's base path and relative path, joined to
the base path of the file that holds the node.

Writing makes one database at the root: every value of 1,024 bytes or
less inline, the rest in one data file `d/<hex>` followed by a single
leaf node, one version, Orbax's config, and zstd frames of raw blocks
(`native/codec.py`). The JAX package's `_load_payload` restores such a
directory.
"""

import ast
import json
import os
import struct
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ggnn_tpu_torch.native import codec

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
NO_NODE = (1 << 64) - 1
# The config Orbax opens its databases with.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


class OrbaxFormatError(ValueError):
    """The directory is not an Orbax checkpoint this reader supports; the
    message names the field."""


# ------------------------------------------------------------- framing


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its framing checked."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise OrbaxFormatError(f"{what}: bad magic number")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise OrbaxFormatError(f"{what}: length field does not match")
    if struct.unpack("<I", raw[-4:])[0] != codec.crc32c(raw[:-4]):
        raise OrbaxFormatError(f"{what}: crc32c mismatch")
    r = _Reader(raw[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version}")
    compression = r.varint()
    body = raw[r.pos:-4]
    if compression == 1:
        return codec.decompress(body)
    if compression != 0:
        raise OrbaxFormatError(f"{what}: compression format {compression}")
    return body


def _wrap(body: bytes, magic: int) -> bytes:
    """A manifest or node file of `body`, zstd-framed."""
    payload = _varint(0) + _varint(1) + codec.compress(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    raw = head + payload
    return raw + struct.pack("<I", codec.crc32c(raw))


def _read_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """A data-file table: each file's (base path, relative path), the
    base path joined to `base`, the base path of the file holding the
    table."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b""
    for k in range(n):
        path = prev[:prefix[k]] + r.take(suffix[k])
        prev = path
        if base_len[k] > len(path):
            raise OrbaxFormatError(f"{r.what}: base path past its path")
        out.append((base + path[:base_len[k]].decode(),
                    path[base_len[k]:].decode()))
    return out


def _write_file_table(paths: List[str]) -> bytes:
    """The table of `paths` (sorted, base path empty)."""
    enc = [p.encode() for p in paths]
    prefix = [_common(enc[k - 1], enc[k]) for k in range(1, len(enc))]
    suffix = [e[p:] for e, p in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + b"".join(map(_varint, prefix))
            + b"".join(_varint(len(s)) for s in suffix)
            + b"".join(_varint(0) for _ in enc) + b"".join(suffix))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


# ----------------------------------------------------------- database


class _Files:
    """The data files of one database, each read once."""

    def __init__(self, root: str):
        self.root, self.cache = root, {}

    def read(self, file: Tuple[str, str], offset: int,
             length: int) -> bytes:
        path = file[0] + file[1]
        if path not in self.cache:
            full = os.path.join(self.root, path)
            if not os.path.isfile(full):
                raise OrbaxFormatError(f"data file {path!r} is missing")
            with open(full, "rb") as f:
                self.cache[path] = f.read()
        data = self.cache[path]
        if offset + length > len(data):
            raise OrbaxFormatError(f"data file {path!r} is truncated")
        return data[offset:offset + length]


def _read_config(r: _Reader) -> Dict:
    config = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
              "max_inline_value_bytes": r.varint(),
              "max_decoded_node_bytes": r.varint(),
              "version_tree_arity_log2": r.byte(),
              "compression": r.varint()}
    if config["compression"] == 1:
        config["zstd_level"] = struct.unpack("<i", r.take(4))[0]
    elif config["compression"] != 0:
        raise OrbaxFormatError(
            f"manifest: config compression {config['compression']}")
    return config


def _root_of(root: str):
    """(data file, offset, length, height) of the newest version's root
    node, or None for an empty database."""
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        r = _Reader(_unwrap(f.read(), MANIFEST_MAGIC, "manifest.ocdbt"),
                    "manifest.ocdbt")
    config = _read_config(r)
    if config["manifest_kind"] != 0:
        raise OrbaxFormatError(
            f"manifest.ocdbt: manifest_kind {config['manifest_kind']} "
            "(only the single-file manifest is supported)")
    files = _read_file_table(r, "")
    n = r.varint()
    if n == 0:
        return None
    generation = r.varints(n)
    height = [r.byte() for _ in range(n)]
    file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
    newest = max(range(n), key=generation.__getitem__)
    if offset[newest] == NO_NODE:
        return None
    if file_id[newest] >= len(files):
        raise OrbaxFormatError("manifest.ocdbt: data file id out of range")
    return (files[file_id[newest]], offset[newest], length[newest],
            height[newest])


def _read_node(files: _Files, ref, prefix: bytes, out: Dict[bytes, bytes]):
    file, offset, length, height = ref
    what = f"B-tree node {file[0] + file[1]}@{offset}"
    r = _Reader(_unwrap(files.read(file, offset, length), NODE_MAGIC, what),
                what)
    if r.byte() != height:
        raise OrbaxFormatError(f"{what}: height does not match its parent")
    table = _read_file_table(r, file[0])
    n = r.varint()
    key_prefix = [0] + r.varints(max(n - 1, 0))
    key_suffix = r.varints(n)
    common = r.varints(n) if height > 0 else None
    keys, prev = [], b""
    for k in range(n):
        key = prev[:key_prefix[k]] + r.take(key_suffix[k])
        keys.append(key)
        prev = key

    def file_of(i):
        if i >= len(table):
            raise OrbaxFormatError(f"{what}: data file id out of range")
        return table[i]

    if height > 0:
        fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
        for k in range(n):
            _read_node(files, (file_of(fid[k]), off[k], ln[k], height - 1),
                       prefix + keys[k][:common[k]], out)
        return
    value_len = r.varints(n)
    kind = r.varints(n)
    indirect = [k for k in range(n) if kind[k] == 1]
    if any(v not in (0, 1) for v in kind):
        raise OrbaxFormatError(f"{what}: unknown value kind")
    fid = r.varints(len(indirect))
    off = r.varints(len(indirect))
    where = dict(zip(indirect, zip(fid, off)))
    for k in range(n):
        if kind[k] == 0:
            out[prefix + keys[k]] = r.take(value_len[k])
        else:
            i, o = where[k]
            out[prefix + keys[k]] = files.read(file_of(i), o, value_len[k])


def read_database(root: str) -> Dict[bytes, bytes]:
    """Every key and value of the newest version of the OCDBT database at
    `root` (a directory holding `manifest.ocdbt`)."""
    ref = _root_of(root)
    out: Dict[bytes, bytes] = {}
    if ref is not None:
        _read_node(_Files(root), ref, b"", out)
    return out


def write_database(root: str, items: Dict[bytes, bytes]) -> None:
    """A new OCDBT database at `root` holding `items`: one version whose
    root is a single leaf, the values past the inline limit and the leaf
    in one data file `d/<hex>`."""
    if not items:
        raise ValueError("an Orbax checkpoint holds at least one array")
    keys = sorted(items)
    data_name = "d/" + os.urandom(16).hex()
    indirect = [k for k in keys if len(items[k]) > MAX_INLINE_VALUE_BYTES]
    blob, offsets, pos = [], [], 0
    for k in indirect:
        offsets.append(pos)
        blob.append(items[k])
        pos += len(items[k])
    prefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffix = [k[p:] for k, p in zip(keys, [0] + prefix)]
    body = (bytes([0]) + _write_file_table([data_name] if indirect else [])
            + _varint(len(keys)) + b"".join(map(_varint, prefix))
            + b"".join(_varint(len(s)) for s in suffix) + b"".join(suffix)
            + b"".join(_varint(len(items[k])) for k in keys)
            + b"".join(_varint(int(len(items[k]) > MAX_INLINE_VALUE_BYTES))
                       for k in keys)
            + b"".join(_varint(0) for _ in indirect)
            + b"".join(map(_varint, offsets))
            + b"".join(items[k] for k in keys
                       if len(items[k]) <= MAX_INLINE_VALUE_BYTES))
    node = _wrap(body, NODE_MAGIC)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, data_name), "wb") as f:
        f.write(b"".join(blob))
        f.write(node)
    manifest = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
                + _varint(MAX_DECODED_NODE_BYTES)
                + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1)
                + struct.pack("<i", 0)
                + _write_file_table([data_name])
                + _varint(1)                      # one version
                + _varint(1) + bytes([0])         # generation 1, a leaf
                + _varint(0) + _varint(pos) + _varint(len(node))
                + _varint(len(keys)) + _varint(len(node)) + _varint(pos)
                + struct.pack("<Q", time.time_ns())
                + _varint(0))                     # no version tree nodes
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_wrap(manifest, MANIFEST_MAGIC))


# ------------------------------------------------------------- zarr v2


def _chunk_key(index, separator: str) -> str:
    return separator.join(map(str, index)) if index else "0"


def _fill(meta: Dict, dtype) -> float:
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": np.nan, "Infinity": np.inf,
                "-Infinity": -np.inf}[value]
    return value


def _decode_array(name: str, kv: Dict[bytes, bytes]):
    """The zarr v2 array `name` of `kv`: a numpy array, or a torch
    bfloat16 tensor for a "bfloat16" array (numpy has no bf16)."""
    raw = kv.get(f"{name}/.zarray".encode())
    if raw is None:
        raise OrbaxFormatError(f"array '{name}' has no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(
            f"array '{name}': zarr_format {meta.get('zarr_format')!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(
            f"array '{name}': compressor {compressor.get('id')!r} (only "
            "zstd or null are supported)")
    if meta.get("filters"):
        raise OrbaxFormatError(f"array '{name}': filters {meta['filters']!r}")
    if meta.get("order", "C") != "C":
        raise OrbaxFormatError(f"array '{name}': order {meta['order']!r}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2") if bf16 else np.dtype(meta["dtype"])
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    separator = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    fill = _fill(meta, dtype)
    if bf16:
        fill = torch.tensor(float(fill), dtype=torch.bfloat16).view(
            torch.int16).item() & 0xFFFF
    out.fill(fill)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        value = kv.get(f"{name}/{_chunk_key(index, separator)}".encode())
        if value is None:
            continue                      # an all-fill chunk left out
        if compressor is not None:
            value = codec.decompress(value)
        chunk = np.frombuffer(value, dtype)
        if chunk.size != int(np.prod(chunks)):
            raise OrbaxFormatError(
                f"array '{name}': chunk {index} holds {chunk.size} "
                f"values, expected {int(np.prod(chunks))}")
        chunk = chunk.reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    out = out.astype(out.dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def _encode_array(name: str, value) -> Dict[bytes, bytes]:
    """The keys of one zarr v2 array, one chunk, zstd, as Orbax writes
    them; `value` a numpy array or a torch tensor (bfloat16 kept)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            data = np.asarray(value.view(torch.int16).numpy(), order="C")
            dtype = "bfloat16"
        else:
            data = np.asarray(value.numpy(), order="C")
            dtype = data.dtype.str
    else:
        data = np.asarray(value, order="C")
        dtype = data.dtype.str
        if data.dtype.kind not in "biuf":
            raise TypeError(f"array '{name}': dtype {data.dtype} has no "
                            "zarr v2 form here")
    if dtype != "bfloat16" and data.dtype.byteorder == ">":
        data = data.astype(data.dtype.newbyteorder("<"))
        dtype = data.dtype.str
    meta = {"chunks": [max(int(s), 1) for s in data.shape],
            "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": list(data.shape),
            "zarr_format": 2}
    out = {f"{name}/.zarray".encode():
           json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()}
    if data.size:
        key = _chunk_key((0,) * data.ndim, ".")
        out[f"{name}/{key}".encode()] = codec.compress(data.tobytes())
    return out


# -------------------------------------------------------- checkpoints


def _tree_names(path: str) -> List[str]:
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(
            f"'{path}': _METADATA has use_zarr3: true (only zarr v2 "
            "arrays are supported)")
    if not meta.get("use_ocdbt", False):
        raise OrbaxFormatError(
            f"'{path}': _METADATA has use_ocdbt: "
            f"{meta.get('use_ocdbt')!r} (only OCDBT storage is supported)")
    names = []
    for key in meta["tree_metadata"]:
        parts = ast.literal_eval(key)
        if not isinstance(parts, tuple) or len(parts) != 1:
            raise OrbaxFormatError(
                f"'{path}': tree_metadata key {key!r} is not a flat name")
        names.append(str(parts[0]))
    return names


def read_arrays(path: str) -> Dict[str, object]:
    """{name: array} of the flat tree a StandardCheckpointer saved at
    `path`."""
    names = _tree_names(path)
    kv = read_database(path)
    return {name: _decode_array(name, kv) for name in names}


def write_arrays(path: str, arrays: Dict[str, object]) -> None:
    """The directory a StandardCheckpointer writes for the flat tree
    `arrays` (`path` must not exist yet); the caller adds its sidecar."""
    os.makedirs(path)
    items: Dict[bytes, bytes] = {}
    for name, value in arrays.items():
        items.update(_encode_array(name, value))
    write_database(path, items)
    tree = {repr((name,)): {"key_metadata": [{"key": name, "key_type": 2}],
                            "value_metadata": {"value_type": "np.ndarray",
                                               "skip_deserialize": False}}
            for name in arrays}
    meta = {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump(meta, f)
    now = time.time_ns()
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
