"""Clean-room TensorBoard event-file writer: the port's own copy of the
JAX package's ``utils/tb_events.py`` (standard library and numpy only).

The reference logs training scalars and an attention-heatmap image to
TensorBoard (``lm_and_am/train.py:51-53`` writes ``mean_loss``/``accuracy``
scalars; ``end2end/transformer.py:105-106`` adds an attention image
summary; writer dirs come from ``util/const.py:46-60``). This repo's
primary metric sink is the JSONL :class:`~..train.trainer.MetricWriter`
(machine-friendly, diff-able), but users coming from the reference expect
``tensorboard --logdir`` to just work — this module closes that gap
without depending on tensorflow/tensorboard at write time.

It hand-encodes the three public formats involved:

- **TFRecord framing**: ``<len:u64le><masked_crc32c(len):u32le><payload>
  <masked_crc32c(payload):u32le>`` per record.
- **Event / Summary protos** (``tensorflow/core/util/event.proto``,
  ``.../framework/summary.proto``): only the fields TensorBoard's scalar
  and image dashboards read — ``wall_time``, ``step``, ``file_version``,
  ``Summary.Value{tag, simple_value, image}``.
- **PNG** for image summaries (stored zlib-deflated, filter 0).

Everything is stdlib + numpy; the test suite round-trips the output
through the real ``tensorboard`` package's ``EventFileLoader`` when it is
installed.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
import zlib
from typing import Optional, Union

import numpy as np

__all__ = ["TBEventWriter", "png_encode", "read_events"]


# ---------------------------------------------------------------------------
# crc32c (Castagnoli) + TFRecord masking
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tbl = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ tbl[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's rotated+offset crc32c mask (record_writer.cc)."""
    c = _crc32c(data)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _int_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    # Event: wall_time=1 double, step=2 int64, file_version=3 string,
    # summary=5 message.
    out = _double_field(1, wall_time)
    if step is not None:
        out += _int_field(2, step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value: tag=1 string, simple_value=2 float.
    return _len_field(1, _len_field(1, tag.encode()) +
                      _float_field(2, float(value)))


def _image_value(tag: str, png: bytes, height: int, width: int,
                 colorspace: int) -> bytes:
    # Summary.Image: height=1, width=2, colorspace=3,
    # encoded_image_string=4.
    img = (_int_field(1, height) + _int_field(2, width) +
           _int_field(3, colorspace) + _len_field(4, png))
    return _len_field(1, _len_field(1, tag.encode()) + _len_field(4, img))


# ---------------------------------------------------------------------------
# reading back (no tensorboard package needed)
# ---------------------------------------------------------------------------

def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: varints as
    ints, 64- and 32-bit fields as their bytes, length-delimited fields as
    bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _read_varint(buf: bytes, i: int):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def read_events(path: str) -> list:
    """The events of one file, each record's two masked CRC32Cs checked
    (a mismatch raises ``ValueError``): a list of dicts with ``wall_time``,
    ``step``, ``file_version`` (or None) and ``values``, each value a dict
    with ``tag`` and either ``simple_value`` or ``image`` ({height, width,
    colorspace, png}). Reads the fields this writer writes."""
    with open(path, "rb") as f:
        data = f.read()
    events, i = [], 0
    while i < len(data):
        head = data[i:i + 8]
        (n,) = struct.unpack("<Q", head)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        if crc != _masked_crc(head):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        payload = data[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(payload) != n or crc != _masked_crc(payload):
            raise ValueError(f"{path}: bad payload CRC at byte {i}")
        i += 16 + n
        ev = {"wall_time": None, "step": 0, "file_version": None,
              "values": []}
        for field, _, val in _fields(payload):
            if field == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2:
                ev["step"] = val
            elif field == 3:
                ev["file_version"] = val.decode()
            elif field == 5:
                for _, _, value in _fields(val):
                    ev["values"].append(_read_value(value))
        events.append(ev)
    return events


def _read_value(buf: bytes) -> dict:
    out = {}
    for field, _, val in _fields(buf):
        if field == 1:
            out["tag"] = val.decode()
        elif field == 2:
            out["simple_value"] = struct.unpack("<f", val)[0]
        elif field == 4:
            img = dict(zip(("height", "width", "colorspace", "png"),
                           (None,) * 4))
            for f2, _, v2 in _fields(val):
                key = {1: "height", 2: "width", 3: "colorspace",
                       4: "png"}.get(f2)
                if key:
                    img[key] = v2
            out["image"] = img
    return out


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def png_encode(img: np.ndarray) -> bytes:
    """Encode a ``uint8`` image array as PNG bytes.

    Accepts ``[H, W]`` (grayscale), ``[H, W, 1]``, ``[H, W, 3]`` (RGB) or
    ``[H, W, 4]`` (RGBA). Float inputs are min-max normalized to uint8
    first (matching how the reference's attention scores — arbitrary
    logits — would render).
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        x = img.astype(np.float64)
        lo, hi = float(x.min()), float(x.max())
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        img = ((x - lo) * scale).astype(np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        color_type, channels = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type, channels = 2, 3
    elif img.ndim == 3 and img.shape[2] == 4:
        color_type, channels = 6, 4
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    raw = img.reshape(h, w * channels)
    # filter byte 0 (None) per scanline
    scanlines = b"".join(b"\x00" + raw[i].tobytes() for i in range(h))

    def chunk(kind: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + kind + payload + \
            struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(scanlines)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class TBEventWriter:
    """Append-only TensorBoard event file in ``logdir``.

    Thread-safe; one ``events.out.tfevents.<ts>.<host>`` file per
    instance, opened lazily on the first write so constructing a writer
    that is never used leaves no file behind.
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        self.logdir = logdir
        self._suffix = filename_suffix
        self._f = None
        self._lock = threading.Lock()
        self.path: Optional[str] = None

    def _ensure_open(self):
        if self._f is not None:
            return
        os.makedirs(self.logdir, exist_ok=True)
        name = (f"events.out.tfevents.{time.time():.6f}."
                f"{socket.gethostname()}{self._suffix}")
        self.path = os.path.join(self.logdir, name)
        self._f = open(self.path, "ab")
        # Readers skip files without the version header record.
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header)) +
                      payload + struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        with self._lock:
            self._ensure_open()
            self._write_record(_event(time.time(), step=int(step),
                                      summary=_scalar_value(tag, value)))

    def image(self, tag: str, img: Union[np.ndarray, bytes], step: int,
              height: Optional[int] = None, width: Optional[int] = None):
        """Write an image summary.

        ``img`` is an array (encoded here, see :func:`png_encode`) or
        pre-encoded PNG bytes (then ``height``/``width`` are required).
        """
        if isinstance(img, (bytes, bytearray)):
            if height is None or width is None:
                raise ValueError("raw PNG bytes need height= and width=")
            png, h, w, cs = bytes(img), height, width, 3
        else:
            arr = np.asarray(img)
            png = png_encode(arr)
            h, w = arr.shape[:2]
            cs = 1 if arr.ndim == 2 or arr.shape[2] == 1 else arr.shape[2]
        with self._lock:
            self._ensure_open()
            self._write_record(_event(time.time(), step=int(step),
                                      summary=_image_value(tag, png, h, w,
                                                           cs)))

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
