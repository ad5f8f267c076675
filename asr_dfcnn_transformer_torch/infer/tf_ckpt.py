"""TF1 checkpoint (tensor_bundle) reader/writer, no TensorFlow needed: the
port's own copy of ``infer/tf_ckpt.py`` (numpy only, as there).

The reference's graph-mode trainers save TF1 checkpoints via
``tf.train.Saver`` (``lm_and_am/train.py:38``) and the eval drivers restore
them (``test.py:126-127``). Those checkpoints are *tensor bundles*: a
``prefix.index`` file — an SSTable (LevelDB block table) mapping tensor
names to BundleEntryProto records — plus raw-bytes data shards
``prefix.data-00000-of-0000N``. This module implements the wire formats
from scratch (varint protobuf, LevelDB block table with shared-prefix keys
and masked CRC32C, snappy decompression).

The loaders and exporters keep the Flax variable-tree interface
(``{"params": ..., "batch_stats": ...}`` of numpy arrays):
``convert.am_state_dict`` / ``lm_state_dict`` take what the loaders give,
``convert.state_dict_to_flax`` gives what the exporters take. A bundle
written here for some tensors is the JAX package's bundle for the same
tensors byte for byte. One change from that file: the CRC32C of a long
buffer runs in numpy lanes (:func:`crc32c`), so a full-width model's
bundle is written and verified in seconds.

Format references (public): tensorflow/core/util/tensor_bundle,
tensorflow/core/lib/io/table (a fork of LevelDB's table), and the snappy
format description.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with the leveldb/TF masking.
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
_LANE_BYTES = 64            # bytes per numpy lane in the long-buffer CRC
_LANE_MIN = 4096            # buffers shorter than this take the byte loop
_SHIFT_OPS: List[np.ndarray] = []   # [4, 256] tables: shift by 64 * 2^i bytes


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def _crc_bytes(data, c: int) -> int:
    """The raw register after feeding ``data`` from state ``c``."""
    tbl = _crc_table()
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


def _op_tables(images: np.ndarray) -> np.ndarray:
    """A GF(2)-linear map of 32-bit registers, given by the images of the
    32 unit registers, as four byte tables: the map of x is the XOR of
    ``t[i][(x >> 8 i) & 255]``."""
    bits = (np.arange(256, dtype=np.uint32)[:, None]
            >> np.arange(8, dtype=np.uint32)) & 1             # [256, 8]
    out = np.zeros((4, 256), np.uint32)
    for i in range(4):
        sel = np.where(bits == 1, images[8 * i:8 * i + 8], 0)
        out[i] = np.bitwise_xor.reduce(sel, axis=1)
    return out


def _apply(t: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF]
            ^ t[2][(x >> 16) & 0xFF] ^ t[3][x >> 24])


def _square(t: np.ndarray) -> np.ndarray:
    """The byte tables of a map applied twice."""
    units = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return _op_tables(_apply(t, _apply(t, units)))


def _shift_op(level: int) -> np.ndarray:
    """The map "feed 64 * 2^level zero bytes" as byte tables (squared up
    from "feed one zero byte", cached)."""
    if not _SHIFT_OPS:
        t = _op_tables(np.array([_crc_bytes(b"\0", 1 << k)
                                 for k in range(32)], np.uint32))
        for _ in range(6):                   # 1 -> 64 bytes
            t = _square(t)
        _SHIFT_OPS.append(t)
    while len(_SHIFT_OPS) <= level:
        _SHIFT_OPS.append(_square(_SHIFT_OPS[-1]))
    return _SHIFT_OPS[level]


def _crc_lanes(data) -> int:
    """The raw register after feeding ``data`` from state 0, in numpy: the
    buffer (zero-padded in front to a multiple of 64 bytes: leading zeros
    leave a zero register at zero) is cut into 64-byte lanes, each lane's
    register is computed side by side, then adjacent registers are merged
    pairwise, ``merge(a, b) = shift(a, len(b)) ^ b`` (a zero lane put in
    front of an odd count changes nothing)."""
    a = np.frombuffer(data, np.uint8)
    pad = -len(a) % _LANE_BYTES
    if pad:
        a = np.concatenate([np.zeros(pad, np.uint8), a])
    rows = a.reshape(-1, _LANE_BYTES).T.copy()          # [64, lanes]
    tbl = np.asarray(_crc_table(), np.uint32)
    c = np.zeros(rows.shape[1], np.uint32)
    for row in rows:
        c = tbl[(c ^ row) & 0xFF] ^ (c >> 8)
    level = 0
    while len(c) > 1:
        if len(c) % 2:
            c = np.concatenate([np.zeros(1, np.uint32), c])
        c = _apply(_shift_op(level), c[0::2]) ^ c[1::2]
        level += 1
    return int(c[0])


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    if len(data) < _LANE_MIN:
        return _crc_bytes(data, c) ^ 0xFFFFFFFF
    # a start register c equals feeding its four little-endian bytes
    # (XORed into the data's first four) from 0
    head = bytes(x ^ y for x, y in zip(data[:4], c.to_bytes(4, "little")))
    return _crc_lanes(head + bytes(data[4:])) ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return ((((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF)


def _unmask(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Varints + minimal protobuf wire format
# ---------------------------------------------------------------------------

def _write_varint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _proto_fields(data: bytes) -> List[Tuple[int, int, object]]:
    """Decode a protobuf message into (field_number, wire_type, value)."""
    fields = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:           # varint
            val, pos = _read_varint(data, pos)
        elif wt == 1:         # fixed64
            val = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wt == 2:         # length-delimited
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wt == 5:         # fixed32
            val = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.append((fnum, wt, val))
    return fields


def _emit_varint_field(buf: bytearray, fnum: int, v: int) -> None:
    _write_varint(buf, (fnum << 3) | 0)
    _write_varint(buf, v)


def _emit_bytes_field(buf: bytearray, fnum: int, b: bytes) -> None:
    _write_varint(buf, (fnum << 3) | 2)
    _write_varint(buf, len(b))
    buf.extend(b)


def _emit_fixed32_field(buf: bytearray, fnum: int, v: int) -> None:
    _write_varint(buf, (fnum << 3) | 5)
    buf.extend(struct.pack("<I", v))


# ---------------------------------------------------------------------------
# TF DataType <-> numpy
# ---------------------------------------------------------------------------

_DT_TO_NP = {
    1: np.dtype(np.float32),   # DT_FLOAT
    2: np.dtype(np.float64),   # DT_DOUBLE
    3: np.dtype(np.int32),     # DT_INT32
    4: np.dtype(np.uint8),     # DT_UINT8
    5: np.dtype(np.int16),     # DT_INT16
    6: np.dtype(np.int8),      # DT_INT8
    9: np.dtype(np.int64),     # DT_INT64
    10: np.dtype(np.bool_),    # DT_BOOL
    19: np.dtype(np.float16),  # DT_HALF
}
_NP_TO_DT = {v: k for k, v in _DT_TO_NP.items()}

try:  # bfloat16 (DT_BFLOAT16 = 14) via ml_dtypes when available
    import ml_dtypes

    _DT_TO_NP[14] = np.dtype(ml_dtypes.bfloat16)
    _NP_TO_DT[np.dtype(ml_dtypes.bfloat16)] = 14
except ImportError:  # pragma: no cover
    pass


# ---------------------------------------------------------------------------
# Snappy decompression (block format): enough to read compressed SSTable
# blocks from TF checkpoints written with kSnappyCompression.
# ---------------------------------------------------------------------------

def snappy_decompress(data: bytes) -> bytes:
    out_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:                      # literal
            ln = (tag >> 2) + 1
            if ln > 60:
                extra = ln - 60
                ln = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            out += data[pos:pos + ln]
            pos += ln
        else:                              # copy
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            if off == 0 or off > len(out):
                raise ValueError("corrupt snappy stream")
            for _ in range(ln):            # may overlap — byte-at-a-time
                out.append(out[-off])
    if len(out) != out_len:
        raise ValueError(f"snappy length mismatch {len(out)} != {out_len}")
    return bytes(out)


# ---------------------------------------------------------------------------
# LevelDB-style block table (SSTable) — reader
# ---------------------------------------------------------------------------

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48  # 2 * BlockHandle::kMaxEncodedLength (40) + magic (8)


def _read_block(raw: bytes, offset: int, size: int,
                verify_crc: bool = True) -> bytes:
    data = raw[offset:offset + size]
    ctype = raw[offset + size]
    if verify_crc:
        stored = struct.unpack_from("<I", raw, offset + size + 1)[0]
        if _unmask(stored) != crc32c(raw[offset:offset + size + 1]):
            raise ValueError("block checksum mismatch")
    if ctype == 0:
        return data
    if ctype == 1:
        return snappy_decompress(data)
    raise ValueError(f"unsupported block compression type {ctype}")


def _block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode all (key, value) pairs with shared-prefix key encoding."""
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 * (1 + num_restarts)
    entries = []
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        entries.append((key, value))
    return entries


def _decode_handle(value: bytes) -> Tuple[int, int]:
    off, pos = _read_varint(value, 0)
    size, _ = _read_varint(value, pos)
    return off, size


def read_sstable(path: str, verify_crc: bool = True) -> Dict[bytes, bytes]:
    """Read every key/value from a LevelDB-format table file."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _FOOTER_LEN:
        raise ValueError(f"{path}: too short for an SSTable")
    footer = raw[-_FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, _FOOTER_LEN - 8)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    _, p = _read_varint(footer, 0)          # metaindex offset
    _, p = _read_varint(footer, p)          # metaindex size
    idx_off, p = _read_varint(footer, p)
    idx_size, p = _read_varint(footer, p)
    index = _read_block(raw, idx_off, idx_size, verify_crc)
    out: Dict[bytes, bytes] = {}
    for _, handle in _block_entries(index):
        off, size = _decode_handle(handle)
        for k, v in _block_entries(_read_block(raw, off, size, verify_crc)):
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# LevelDB-style block table — writer (no compression, restart every key)
# ---------------------------------------------------------------------------

def _build_block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    buf = bytearray()
    restarts = []
    for key, value in entries:
        restarts.append(len(buf))          # restart at every entry
        _write_varint(buf, 0)              # shared
        _write_varint(buf, len(key))       # non_shared
        _write_varint(buf, len(value))
        buf.extend(key)
        buf.extend(value)
    for r in restarts:
        buf.extend(struct.pack("<I", r))
    buf.extend(struct.pack("<I", max(len(restarts), 1)))
    if not restarts:
        buf = bytearray(struct.pack("<II", 0, 1))
    return bytes(buf)


def _append_block(out: bytearray, block: bytes) -> Tuple[int, int]:
    offset = len(out)
    out.extend(block)
    out.append(0)                          # kNoCompression
    out.extend(struct.pack("<I", masked_crc32c(block + b"\x00")))
    return offset, len(block)


def write_sstable(path: str, items: Dict[bytes, bytes]) -> None:
    """Write keys/values (sorted) as a single-data-block LevelDB table."""
    entries = sorted(items.items())
    out = bytearray()
    data_handle = _append_block(out, _build_block(entries))
    meta_handle = _append_block(out, _build_block([]))
    idx = bytearray()
    _write_varint(idx, data_handle[0])
    _write_varint(idx, data_handle[1])
    last_key = entries[-1][0] if entries else b""
    index_handle = _append_block(
        out, _build_block([(last_key + b"\x00", bytes(idx))]))
    footer = bytearray()
    _write_varint(footer, meta_handle[0])
    _write_varint(footer, meta_handle[1])
    _write_varint(footer, index_handle[0])
    _write_varint(footer, index_handle[1])
    footer.extend(b"\x00" * (_FOOTER_LEN - 8 - len(footer)))
    footer.extend(struct.pack("<Q", _TABLE_MAGIC))
    out.extend(footer)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# BundleHeaderProto / BundleEntryProto
# ---------------------------------------------------------------------------

def _decode_shape(data: bytes) -> Tuple[int, ...]:
    dims = []
    for fnum, _, val in _proto_fields(data):
        if fnum == 2:                      # repeated Dim
            size = 0
            for dn, _, dv in _proto_fields(val):
                if dn == 1:
                    size = dv if dv < (1 << 63) else dv - (1 << 64)
            dims.append(size)
    return tuple(dims)


def _encode_shape(shape: Tuple[int, ...]) -> bytes:
    buf = bytearray()
    for d in shape:
        dim = bytearray()
        _emit_varint_field(dim, 1, d)
        _emit_bytes_field(buf, 2, bytes(dim))
    return bytes(buf)


class BundleEntry:
    def __init__(self, dtype: int, shape: Tuple[int, ...], shard_id: int,
                 offset: int, size: int, crc: int):
        self.dtype, self.shape = dtype, shape
        self.shard_id, self.offset, self.size, self.crc = (
            shard_id, offset, size, crc)

    @classmethod
    def decode(cls, data: bytes) -> "BundleEntry":
        dtype = shard = offset = size = crc = 0
        shape: Tuple[int, ...] = ()
        for fnum, _, val in _proto_fields(data):
            if fnum == 1:
                dtype = val
            elif fnum == 2:
                shape = _decode_shape(val)
            elif fnum == 3:
                shard = val
            elif fnum == 4:
                offset = val
            elif fnum == 5:
                size = val
            elif fnum == 6:
                crc = val
        return cls(dtype, shape, shard, offset, size, crc)

    def encode(self) -> bytes:
        buf = bytearray()
        _emit_varint_field(buf, 1, self.dtype)
        _emit_bytes_field(buf, 2, _encode_shape(self.shape))
        if self.shard_id:
            _emit_varint_field(buf, 3, self.shard_id)
        if self.offset:
            _emit_varint_field(buf, 4, self.offset)
        _emit_varint_field(buf, 5, self.size)
        _emit_fixed32_field(buf, 6, self.crc)
        return bytes(buf)


def _encode_header(num_shards: int) -> bytes:
    buf = bytearray()
    _emit_varint_field(buf, 1, num_shards)
    # field 2 endianness: 0 = little (default, omitted)
    version = bytearray()
    _emit_varint_field(version, 1, 1)      # VersionDef.producer = 1
    _emit_bytes_field(buf, 3, bytes(version))
    return bytes(buf)


def _decode_header_num_shards(data: bytes) -> int:
    for fnum, _, val in _proto_fields(data):
        if fnum == 1:
            return int(val)
    return 1


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_tf_checkpoint(prefix: str, verify_crc: bool = True
                       ) -> Dict[str, np.ndarray]:
    """Load every tensor from a TF tensor_bundle checkpoint ``prefix``
    (the path passed to ``tf.train.Saver.save``/``restore``, i.e. without
    the ``.index`` suffix). Returns {variable_name: array}."""
    index_path = prefix + ".index"
    if not os.path.exists(index_path):
        raise FileNotFoundError(index_path)
    table = read_sstable(index_path, verify_crc)
    num_shards = 1
    if b"" in table:
        num_shards = _decode_header_num_shards(table.pop(b""))
    shards: Dict[int, bytes] = {}
    out: Dict[str, np.ndarray] = {}
    for key, value in table.items():
        entry = BundleEntry.decode(value)
        if entry.dtype not in _DT_TO_NP:
            raise ValueError(
                f"{key.decode()}: unsupported TF dtype {entry.dtype}")
        if entry.shard_id not in shards:
            with open(_shard_path(prefix, entry.shard_id, num_shards),
                      "rb") as f:
                shards[entry.shard_id] = f.read()
        raw = shards[entry.shard_id][entry.offset:entry.offset + entry.size]
        if verify_crc and entry.crc and _unmask(entry.crc) != crc32c(raw):
            raise ValueError(f"{key.decode()}: tensor data checksum "
                             f"mismatch")
        dt = _DT_TO_NP[entry.dtype]
        arr = np.frombuffer(raw, dtype=dt).reshape(entry.shape)
        out[key.decode()] = arr
    return out


def write_tf_checkpoint(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write {name: array} as a single-shard TF tensor_bundle checkpoint
    readable by ``tf.train.load_checkpoint`` / ``Saver.restore`` (and by
    :func:`read_tf_checkpoint`)."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    data = bytearray()
    items: Dict[bytes, bytes] = {b"": _encode_header(1)}
    for name in sorted(tensors):
        # np.asarray, not ascontiguousarray: the latter promotes 0-d
        # scalars to shape (1,); .tobytes() already yields C order.
        arr = np.asarray(tensors[name])
        if arr.dtype not in _NP_TO_DT:
            raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
        raw = arr.tobytes()
        entry = BundleEntry(_NP_TO_DT[arr.dtype], tuple(arr.shape),
                            shard_id=0, offset=len(data), size=len(raw),
                            crc=masked_crc32c(raw))
        data.extend(raw)
        items[name.encode()] = entry.encode()
    with open(_shard_path(prefix, 0, 1), "wb") as f:
        f.write(bytes(data))
    write_sstable(prefix + ".index", items)


def list_tf_checkpoint(prefix: str) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{name: (dtype_name, shape)} without reading tensor data."""
    table = read_sstable(prefix + ".index", verify_crc=False)
    table.pop(b"", None)
    out = {}
    for key, value in table.items():
        e = BundleEntry.decode(value)
        dt = _DT_TO_NP.get(e.dtype)
        out[key.decode()] = (dt.name if dt is not None else f"dt{e.dtype}",
                             e.shape)
    return out


# ---------------------------------------------------------------------------
# Variable-name mapping: TF1 graph-mode models -> Flax params
# ---------------------------------------------------------------------------

def _tfname(base: str, i: int) -> str:
    return base if i == 0 else f"{base}_{i}"


def load_tf1_sedfcnn(prefix_or_tensors, vocab_size: int):
    """Map a TF1 SE-DFCNN checkpoint (acoustic_model2.py:37-62 build
    order) onto ``models.SEDFCNN`` variables.

    tf.layers auto-names variables in creation order: per stage
    ``cnn_cell(pool)`` -> conv2d_N + batch_normalization_M (one conv+BN
    each, acoustic_model2.py:125-132), ``cnn_cell`` again, then the SE
    block -> BN + dense(c/ratio) + dense(c) (:141-148); after the 5
    stages one head cell (conv2d_10 + BN) and the single vocab dense
    (:62-66). The same creation order drives this positional map.
    """
    t = (read_tf_checkpoint(prefix_or_tensors)
         if isinstance(prefix_or_tensors, str) else dict(prefix_or_tensors))

    conv_i = bn_i = dense_i = 0
    params: Dict = {}
    batch_stats: Dict = {}

    def take_conv_bn(cell_name: str):
        nonlocal conv_i, bn_i
        cn, bn = _tfname("conv2d", conv_i), _tfname("batch_normalization",
                                                    bn_i)
        conv_i += 1
        bn_i += 1
        params[cell_name] = {
            "Conv_0": {"kernel": t[f"{cn}/kernel"], "bias": t[f"{cn}/bias"]},
            "BatchNorm_0": {"scale": t[f"{bn}/gamma"],
                            "bias": t[f"{bn}/beta"]},
        }
        batch_stats[cell_name] = {
            "BatchNorm_0": {"mean": t[f"{bn}/moving_mean"],
                            "var": t[f"{bn}/moving_variance"]},
        }

    def take_se(se_name: str):
        nonlocal bn_i, dense_i
        bn = _tfname("batch_normalization", bn_i)
        bn_i += 1
        d1, d2 = _tfname("dense", dense_i), _tfname("dense", dense_i + 1)
        dense_i += 2
        params[se_name] = {
            "BatchNorm_0": {"scale": t[f"{bn}/gamma"],
                            "bias": t[f"{bn}/beta"]},
            "Dense_0": {"kernel": t[f"{d1}/kernel"], "bias": t[f"{d1}/bias"]},
            "Dense_1": {"kernel": t[f"{d2}/kernel"], "bias": t[f"{d2}/bias"]},
        }
        batch_stats[se_name] = {
            "BatchNorm_0": {"mean": t[f"{bn}/moving_mean"],
                            "var": t[f"{bn}/moving_variance"]},
        }

    for stage in range(5):
        take_conv_bn(f"ConvBnCell_{2 * stage}")
        take_conv_bn(f"ConvBnCell_{2 * stage + 1}")
        take_se(f"SqueezeExcite_{stage}")
    take_conv_bn("ConvBnCell_10")
    d = _tfname("dense", dense_i)
    params["Dense_0"] = {"kernel": t[f"{d}/kernel"], "bias": t[f"{d}/bias"]}
    out_dim = np.asarray(params["Dense_0"]["kernel"]).shape[1]
    if out_dim != vocab_size:
        raise ValueError(f"checkpoint vocab {out_dim} != {vocab_size}")
    return {"params": params, "batch_stats": batch_stats}


def load_tf1_lm(prefix_or_tensors, input_vocab_size: int,
                output_vocab_size: int, num_blocks: int = 12):
    """Map a TF1 ``language_model`` checkpoint (``logs_lm/checkpoint``,
    language_model.py:26-56 graph) onto ``models.TransformerLM`` variables.

    TF1 variable names (creation order in the reference graph):
    - ``enc_embed/lookup_table`` / ``enc_pe/lookup_table`` — token and
      learned position embeddings (transformer.py:42-46).
    - per block ``num_blocks_{i}/multihead_attention/dense[_1/_2/_3]/kernel``
      — the ReLU'd bias-free Q/K/V/out projections (transformer.py:139-153);
      ``.../ln/Variable`` (beta) and ``.../ln/Variable_1`` (gamma) — the
      unnamed ``tf.Variable``s of layer_norm, beta created first
      (transformer.py:22-24).
    - per block ``num_blocks_{i}/positionwise_ffnn/conv1d[_1]/{kernel,bias}``
      — 1x1 conv FFN; kernels are [1, C, F], squeezed to Dense [C, F]
      (transformer.py:216-224) — plus its own ``ln`` pair.
    - ``dense/{kernel,bias}`` — the root-scope output projection
      (language_model.py:54).

    Only the single-stack ``language_model`` layout is supported:
    ``language_model2``'s second block group reuses the dense scopes via
    AUTO_REUSE but creates fresh (scope-uniquified) layer-norm variables,
    so its checkpoints are not a well-defined target (PARITY.md).

    Requires ``TransformerLM(parity_attention=True)`` (the default) — the
    TF1 graph has no Q/K/V/out biases to import.
    """
    t = (read_tf_checkpoint(prefix_or_tensors)
         if isinstance(prefix_or_tensors, str) else dict(prefix_or_tensors))
    emb = np.asarray(t["enc_embed/lookup_table"])
    if emb.shape[0] != input_vocab_size:
        raise ValueError(
            f"checkpoint input vocab {emb.shape[0]} != {input_vocab_size}")
    out_k = np.asarray(t["dense/kernel"])
    if out_k.shape[1] != output_vocab_size:
        raise ValueError(
            f"checkpoint output vocab {out_k.shape[1]} != "
            f"{output_vocab_size}")
    params: Dict = {
        "token_embed": {"embedding": emb},
        "pos_embed": {"embedding": t["enc_pe/lookup_table"]},
        "output": {"kernel": out_k, "bias": t["dense/bias"]},
    }
    for i in range(num_blocks):
        mha = f"num_blocks_{i}/multihead_attention"
        ffn = f"num_blocks_{i}/positionwise_ffnn"
        params[f"block0_{i}_attn"] = {
            "q": {"kernel": t[f"{mha}/dense/kernel"]},
            "k": {"kernel": t[f"{mha}/dense_1/kernel"]},
            "v": {"kernel": t[f"{mha}/dense_2/kernel"]},
            "out": {"kernel": t[f"{mha}/dense_3/kernel"]},
            "LayerNorm_0": {"scale": t[f"{mha}/ln/Variable_1"],
                            "bias": t[f"{mha}/ln/Variable"]},
        }
        params[f"block0_{i}_ffn"] = {
            "Dense_0": {
                "kernel": np.asarray(t[f"{ffn}/conv1d/kernel"])[0],
                "bias": t[f"{ffn}/conv1d/bias"]},
            "Dense_1": {
                "kernel": np.asarray(t[f"{ffn}/conv1d_1/kernel"])[0],
                "bias": t[f"{ffn}/conv1d_1/bias"]},
            "LayerNorm_0": {"scale": t[f"{ffn}/ln/Variable_1"],
                            "bias": t[f"{ffn}/ln/Variable"]},
        }
    return {"params": params}


def export_tf1_lm(variables, num_blocks: int = 12) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_tf1_lm`: flatten ``models.TransformerLM``
    variables (single stack, parity attention) to the TF1 names the
    reference's LM Saver writes (train.py:148), including a zero
    ``global_step``."""
    p = variables["params"]
    t: Dict[str, np.ndarray] = {
        "enc_embed/lookup_table": np.asarray(
            p["token_embed"]["embedding"]),
        "enc_pe/lookup_table": np.asarray(p["pos_embed"]["embedding"]),
        "dense/kernel": np.asarray(p["output"]["kernel"]),
        "dense/bias": np.asarray(p["output"]["bias"]),
        "global_step": np.array(0, np.int32),
    }
    for i in range(num_blocks):
        attn = p[f"block0_{i}_attn"]
        if "bias" in attn["q"]:
            raise ValueError(
                "TF1 export requires parity_attention=True (bias-free "
                "Q/K/V/out) — the TF1 graph has no attention biases")
        ffn = p[f"block0_{i}_ffn"]
        mha = f"num_blocks_{i}/multihead_attention"
        pwf = f"num_blocks_{i}/positionwise_ffnn"
        for proj, tf_d in (("q", "dense"), ("k", "dense_1"),
                           ("v", "dense_2"), ("out", "dense_3")):
            t[f"{mha}/{tf_d}/kernel"] = np.asarray(attn[proj]["kernel"])
        t[f"{mha}/ln/Variable"] = np.asarray(attn["LayerNorm_0"]["bias"])
        t[f"{mha}/ln/Variable_1"] = np.asarray(attn["LayerNorm_0"]["scale"])
        for j, tf_c in ((0, "conv1d"), (1, "conv1d_1")):
            t[f"{pwf}/{tf_c}/kernel"] = np.asarray(
                ffn[f"Dense_{j}"]["kernel"])[None, :, :]
            t[f"{pwf}/{tf_c}/bias"] = np.asarray(ffn[f"Dense_{j}"]["bias"])
        t[f"{pwf}/ln/Variable"] = np.asarray(ffn["LayerNorm_0"]["bias"])
        t[f"{pwf}/ln/Variable_1"] = np.asarray(ffn["LayerNorm_0"]["scale"])
    if f"block0_{num_blocks}_attn" in p:
        raise ValueError(
            f"variables have more than num_blocks={num_blocks} blocks "
            f"(pass the model's num_blocks)")
    if "block1_0_attn" in p:
        raise ValueError(
            "two_stack TransformerLM cannot be exported to the TF1 layout "
            "(language_model2's scope reuse is ambiguous — PARITY.md)")
    return t


def export_tf1_sedfcnn(variables) -> Dict[str, np.ndarray]:
    """Inverse of :func:`load_tf1_sedfcnn`: flatten ``models.SEDFCNN``
    variables to the TF1 variable names the reference's Saver would write,
    so our training state can be handed back to the TF stack (or
    round-tripped through :func:`write_tf_checkpoint`)."""
    p, bs = variables["params"], variables["batch_stats"]
    t: Dict[str, np.ndarray] = {}
    conv_i = bn_i = dense_i = 0

    def put_conv_bn(cell_name: str):
        nonlocal conv_i, bn_i
        cn, bn = _tfname("conv2d", conv_i), _tfname("batch_normalization",
                                                    bn_i)
        conv_i += 1
        bn_i += 1
        t[f"{cn}/kernel"] = np.asarray(p[cell_name]["Conv_0"]["kernel"])
        t[f"{cn}/bias"] = np.asarray(p[cell_name]["Conv_0"]["bias"])
        t[f"{bn}/gamma"] = np.asarray(p[cell_name]["BatchNorm_0"]["scale"])
        t[f"{bn}/beta"] = np.asarray(p[cell_name]["BatchNorm_0"]["bias"])
        t[f"{bn}/moving_mean"] = np.asarray(
            bs[cell_name]["BatchNorm_0"]["mean"])
        t[f"{bn}/moving_variance"] = np.asarray(
            bs[cell_name]["BatchNorm_0"]["var"])

    def put_se(se_name: str):
        nonlocal bn_i, dense_i
        bn = _tfname("batch_normalization", bn_i)
        bn_i += 1
        t[f"{bn}/gamma"] = np.asarray(p[se_name]["BatchNorm_0"]["scale"])
        t[f"{bn}/beta"] = np.asarray(p[se_name]["BatchNorm_0"]["bias"])
        t[f"{bn}/moving_mean"] = np.asarray(
            bs[se_name]["BatchNorm_0"]["mean"])
        t[f"{bn}/moving_variance"] = np.asarray(
            bs[se_name]["BatchNorm_0"]["var"])
        for j in range(2):
            d = _tfname("dense", dense_i)
            dense_i += 1
            t[f"{d}/kernel"] = np.asarray(p[se_name][f"Dense_{j}"]["kernel"])
            t[f"{d}/bias"] = np.asarray(p[se_name][f"Dense_{j}"]["bias"])

    for stage in range(5):
        put_conv_bn(f"ConvBnCell_{2 * stage}")
        put_conv_bn(f"ConvBnCell_{2 * stage + 1}")
        put_se(f"SqueezeExcite_{stage}")
    put_conv_bn("ConvBnCell_10")
    d = _tfname("dense", dense_i)
    t[f"{d}/kernel"] = np.asarray(p["Dense_0"]["kernel"])
    t[f"{d}/bias"] = np.asarray(p["Dense_0"]["bias"])
    return t
