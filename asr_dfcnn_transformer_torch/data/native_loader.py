"""The native wav decoder: the port's ``ctypes`` binding for
``csrc/wavio.cc`` (a copy of the JAX package's ``native/wavio.cc``), with
the JAX module's ``available``, ``probe`` and ``decode_batch``.

The C++ library parses RIFF headers and PCM-decodes a whole batch in a
persistent thread pool, writing float32 [-1, 1] rows straight into the
numpy batch. At first use it is built with the host's C++ compiler (``CXX``,
default ``g++``) and ``native/Makefile``'s flags into
``_kernel_build/wavio-<hash of source, compiler and flags>/``; a
``libasrwav.so`` left anywhere else is never loaded. Where the JAX module
falls back to Python quietly, this one raises with the compiler's output.
The Python decoder stays beside it as the plain version, taken only when a
caller asks for it (``decoder="python"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import wave
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from asr_dfcnn_transformer_torch.audio.wav import read_wav

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "wavio.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_kernel_build"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread")
DECODERS = ("native", "python")

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/wavio.cc`` (once per source, compiler and flags) and
    return the library's path; raises RuntimeError with the compiler's
    output when the build fails."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    out = BUILD_ROOT / f"wavio-{h.hexdigest()[:16]}" / "libasrwav.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"building the wav decoder: {' '.join(cmd)}: "
                           f"{e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building the wav decoder failed "
                           f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.asrwav_probe.restype = ctypes.c_int64
            lib.asrwav_probe.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int32)]
            lib.asrwav_decode_batch.restype = ctypes.c_int32
            lib.asrwav_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded (building it at first
    use); a failed build raises."""
    return _load() is not None


def probe(path: str) -> Tuple[int, int]:
    """Header-only (num_samples, sample_rate); raises IOError on a file the
    decoder cannot parse."""
    sr = ctypes.c_int32(0)
    n = _load().asrwav_probe(path.encode(), ctypes.byref(sr))
    if n < 0:
        raise IOError(f"cannot parse wav: {path}")
    return int(n), int(sr.value)


def decode_batch(paths: List[str], max_samples: int,
                 out: Optional[np.ndarray] = None, decoder: str = "native"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` into a [B, max_samples] float32 array (+ int64
    lengths), each row cut at ``max_samples`` and zero past its length.
    Rows of files that fail come back zero with length -1 (the loader
    drops them). ``decoder`` "python" takes the plain decoder
    (``audio/wav.py``)."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder={decoder!r}: expected one of {DECODERS}")
    b = len(paths)
    if out is None:
        out = np.empty((b, max_samples), np.float32)
    if out.shape != (b, max_samples) or out.dtype != np.float32 or \
            not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous float32 "
                         f"[{b}, {max_samples}] array")
    lengths = np.empty((b,), np.int64)
    if decoder == "python":
        for i, p in enumerate(paths):
            try:
                sig, _ = read_wav(p)
            except (OSError, EOFError, ValueError, wave.Error):
                out[i] = 0
                lengths[i] = -1
                continue
            n = min(len(sig), max_samples)
            out[i, :n] = sig[:n]
            out[i, n:] = 0
            lengths[i] = n
        return out, lengths
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    _load().asrwav_decode_batch(
        arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, lengths
