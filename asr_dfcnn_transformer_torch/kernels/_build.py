"""Build the CUDA sources under ``csrc/`` into one shared library and bind it.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links the objects into a library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The build runs at first use and lands in
``_kernel_build/<hash of the sources and flags>/``, a directory that git
ignores, so an edited source rebuilds and an unchanged one is reused.

Also holds the launch counters: every kernel wrapper adds one to its name's
count where it launches its kernel, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_kernel_build"
LIB_NAME = "libasr_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "asr_error_string": ((_I,), ctypes.c_char_p),
    "asr_log_mel": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
                    _I),
    "asr_cmvn_plan": ((_I, _I, _I, _I), ctypes.c_longlong),
    "asr_cmvn": ((_P, _P, _P, _I, _I, _I, _P), _I),
    "asr_masked_attention_smem": ((_I, _I, _I), ctypes.c_longlong),
    "asr_masked_attention_path": ((_I, _I, _I, _I), _I),
    "asr_masked_attention_mma_smem": ((_I, _I), ctypes.c_longlong),
    "asr_masked_attention": ((_I, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I,
                              _I, _I, _F, _I, _P), _I),
    "asr_masked_attention_bwd_smem": ((_I, _I), ctypes.c_longlong),
    "asr_masked_attention_bwd_path": ((_I, _I, _I, _I), _I),
    "asr_masked_attention_bwd_mma_smem": ((_I, _I, _I), ctypes.c_longlong),
    "asr_masked_attention_bwd": ((_I, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P,
                                  _P, _I, _I, _I, _I, _I, _F, _I, _P), _I),
    "asr_dual_attention": ((_I, _P, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    "asr_dual_attention_bwd_smem": ((_I, _I, _I), ctypes.c_longlong),
    "asr_dual_attention_bwd": ((_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _F, _P), _I),
    "asr_ctc_max_states": ((), _I),
    "asr_ctc_alpha": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "asr_ctc_beta_xi_plan": ((_I, _I), ctypes.c_longlong),
    "asr_ctc_beta_xi": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
                        _I),
    "asr_topk_last": ((_P, _P, _P, _I, _I, _I, _P), _I),
    "asr_fused_ffn_plan": ((_I, _I, _I, _I, _I), ctypes.c_longlong),
    "asr_fused_ffn": ((_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P), _I),
    "asr_interleave_epilogue": ((_I, _P, _P, _P, _I, _I, _I, _F, _P), _I),
    "asr_beam_search": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P), _I),
}

#: the kernels' dtype_code argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = collections.Counter()

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    LAUNCHES.clear()


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       f"({home}); the CUDA kernels cannot be built")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise on the first failure, else
    return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` (when not already built) and return the
    library's path. The compiler's ``-Xptxas -v`` report (registers,
    shared memory, spills per kernel) is kept beside it as ``build.log``."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    units = [s for s in sources if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in units]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(units, objs)])
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                      *[str(o) for o in objs]]])
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)   # atomic: a concurrent build reads a whole file
    return lib


def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def build_log() -> str:
    """The compiler's report for the current sources ('' before a build)."""
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    log = BUILD_ROOT / _digest(sources) / "build.log"
    return log.read_text() if log.is_file() else ""


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, rc: int, sizes: str = "") -> None:
    """Raise if a launch returned a CUDA error; count it otherwise. A
    launcher refuses sizes outside what its kernel takes (the limits stand
    in its ``csrc/`` source) with CUDA's invalid-argument error, so the
    message carries the launch's ``sizes``."""
    if rc != 0:
        msg = library().asr_error_string(rc).decode()
        at = f" at {sizes}" if sizes else ""
        raise RuntimeError(f"{name} kernel launch failed{at}: CUDA error "
                           f"{rc} ({msg})")
    LAUNCHES[name] += 1


def no_grad_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise when an input of a kernel without a backward requires grad,
    rather than return an output cut off from the graph."""
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward: its inputs must not "
                         "require grad")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got "
                         f"{dev.type}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return dev
