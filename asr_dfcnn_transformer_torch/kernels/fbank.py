"""``log_mel`` and ``cmvn``: the front end's two kernels, each with its twin.

``log_mel`` replaces ``ops/pallas/fbank_kernel.py: pallas_log_mel`` and
``cmvn`` replaces ``pallas_cmvn``; the CUDA sources are ``csrc/fbank.cu``.
The ``log_mel`` kernel takes a real FFT in f64 and a sparse mel
projection, with tables built here on the host (``fft_twiddles_np``,
``mel_spans_np``); its twin keeps the f64 matrix-product DFT. The ``cmvn``
kernel runs one thread-block cluster per utterance; ``cmvn_plan`` mirrors
its tiling and ``cmvn_blocked_np`` its order of sums.
Each wrapper calls its custom op (``asr_port::log_mel``,
``asr_port::cmvn``), which runs the plain-PyTorch twin (``*_reference``)
for CPU tensors and launches the kernel for CUDA tensors; the wrapper
raises for anything else. Neither
has a backward: both raise when an input requires grad, rather than return
an output cut off from the graph.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from asr_dfcnn_transformer_torch.audio.fbank import (
    FbankConfig,
    _dft_bases_np,
    mel_filterbank,
)
from asr_dfcnn_transformer_torch.kernels import _build

EPS = float(np.finfo(np.float64).eps)


def _check_geometry(cfg: FbankConfig) -> None:
    if (cfg.win_len, cfg.hop, cfg.nfft) != (400, 160, 512):
        raise ValueError("the fbank kernels are fixed to win 400 / hop 160 / "
                         f"nfft 512, got {cfg.win_len}/{cfg.hop}/{cfg.nfft}")


@functools.lru_cache(maxsize=8)
def _bases(cfg: FbankConfig, device: torch.device):
    """The twin's tables: (cos [400, 257], sin [400, 257], mel [257,
    nfilt]) f32 on ``device``."""
    cos_b, sin_b = _dft_bases_np(cfg.win_len, cfg.nfft)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cos_b, sin_b, mel_filterbank(cfg)))


def fft_twiddles_np(nfft: int = 512) -> np.ndarray:
    """The kernel's twiddles: exp(-2 pi i m / nfft), m = 0..nfft-1, as f64
    [nfft, 2] (real, imaginary)."""
    w = np.exp(-2j * np.pi * np.arange(nfft) / nfft)
    return np.ascontiguousarray(np.stack([w.real, w.imag], axis=1))


def mel_spans_np(mel: np.ndarray):
    """The mel bank [bins, nfilt] in the kernel's sparse form: (spans
    [nfilt, 3] int32, weights [nnz] f32). Filter j's span runs from its
    first to its last non-zero bin; its row of ``spans`` holds that first
    bin, the count and the offset of the span's weights (the dense
    column's values, in bin order) in ``weights``. An empty filter has
    count 0."""
    spans = np.zeros((mel.shape[1], 3), np.int32)
    weights = []
    off = 0
    for j in range(mel.shape[1]):
        nz = np.flatnonzero(mel[:, j])
        if nz.size:
            first, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
            weights.append(mel[first:first + count, j])
            spans[j] = (first, count, off)
            off += count
        else:
            spans[j] = (0, 0, off)
    flat = (np.concatenate(weights) if weights else np.zeros(0)).astype(
        np.float32)
    return spans, flat


@functools.lru_cache(maxsize=8)
def _fft_tables(cfg: FbankConfig, device: torch.device):
    """The kernel's tables on ``device``: (twiddles [512, 2] f64, spans
    [nfilt, 3] int32, weights f32), uploaded once."""
    spans, weights = mel_spans_np(mel_filterbank(cfg))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (fft_twiddles_np(cfg.nfft), spans, weights))


def log_mel_reference(signals: torch.Tensor, lengths: torch.Tensor,
                      n_frames: int,
                      cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """Plain-PyTorch twin of the ``log_mel`` kernel (same contract)."""
    b, s = signals.shape
    x = signals.to(torch.float32)
    pe = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)
    # mask AFTER pre-emphasis: kills the -c*x[len-1] spike past the end
    pe = pe * (torch.arange(s, device=x.device)[None, :]
               < lengths.to(x.device)[:, None])
    need = (n_frames - 1) * cfg.hop + cfg.win_len
    if s < need:
        pe = torch.nn.functional.pad(pe, (0, need - s))
    frames = pe[:, :need].unfold(1, cfg.win_len, cfg.hop)   # [B, T, win]
    cos_b, sin_b, mel = _bases(cfg, x.device)
    # f64 DFT sums, as the kernel: near-null bins cancel badly in f32
    frames = frames.double()
    re = frames @ cos_b.double()
    im = frames @ sin_b.double()
    power = ((re * re + im * im) / cfg.nfft).float()
    return torch.log(torch.clamp_min(power @ mel, EPS))


def _op_cfg(nfilt: int, preemph: float, sample_rate: int, low_freq: float,
            high_freq: Optional[float]) -> FbankConfig:
    return FbankConfig(sample_rate=sample_rate, nfilt=nfilt, preemph=preemph,
                       low_freq=low_freq, high_freq=high_freq)


def _log_mel_cpu(signals: torch.Tensor, lengths: torch.Tensor, n_frames: int,
                 nfilt: int, preemph: float, sample_rate: int,
                 low_freq: float, high_freq: Optional[float]) -> torch.Tensor:
    """The op under ``log_mel``: the twin for CPU tensors."""
    return log_mel_reference(signals, lengths, n_frames,
                             _op_cfg(nfilt, preemph, sample_rate, low_freq,
                                     high_freq))


def _log_mel_cuda(signals, lengths, n_frames, nfilt, preemph, sample_rate,
                  low_freq, high_freq):
    """The op under ``log_mel``: the kernel for CUDA tensors."""
    cfg = _op_cfg(nfilt, preemph, sample_rate, low_freq, high_freq)
    dev = _build.require_cuda("log_mel", signals, lengths)
    b, s = signals.shape
    twiddles, spans, weights = _fft_tables(cfg, dev)
    out = torch.empty((b, n_frames, cfg.nfilt), device=dev,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_log_mel(
            signals.data_ptr(), lengths.data_ptr(), twiddles.data_ptr(),
            spans.data_ptr(), weights.data_ptr(), out.data_ptr(), b, s,
            n_frames, cfg.nfilt, cfg.preemph, 1.0 / cfg.nfft,
            _build.stream_ptr(dev))
    _build.check("log_mel", rc)
    return out


def _log_mel_fake(signals, lengths, n_frames, nfilt, preemph, sample_rate,
                  low_freq, high_freq):
    return signals.new_empty((signals.shape[0], n_frames, nfilt))


_log_mel_op = _build.define_op("log_mel", _log_mel_cpu, _log_mel_cuda,
                               _log_mel_fake)


def log_mel(signals: torch.Tensor, lengths: torch.Tensor, n_frames: int,
            cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[B, S] f32 raw signals + [B] int32 sample lengths -> [B, n_frames,
    nfilt] f32 log-mel. Pre-emphasis and the signal-end mask are applied
    inside; frames past the signal read zeros. The kernel's FFT runs in
    f64 (see csrc/fbank.cu), the rest in f32."""
    _check_geometry(cfg)
    if signals.dim() != 2 or signals.dtype != torch.float32:
        raise ValueError("log_mel: signals must be [B, S] float32, got "
                         f"{tuple(signals.shape)} {signals.dtype}")
    if lengths.shape != (signals.shape[0],) or lengths.dtype != torch.int32:
        raise ValueError("log_mel: lengths must be [B] int32")
    if n_frames < 1:
        raise ValueError(f"log_mel: n_frames must be >= 1, got {n_frames}")
    _build.no_grad_inputs("log_mel", signals)
    _build.check_device("log_mel", signals, lengths)
    return _log_mel_op(signals, lengths, n_frames, cfg.nfilt,
                       float(cfg.preemph), cfg.sample_rate,
                       float(cfg.low_freq),
                       None if cfg.high_freq is None
                       else float(cfg.high_freq))


def cmvn_reference(feat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of the ``cmvn`` kernel (``audio.fbank.cmvn``
    semantics of the JAX package, batched)."""
    t = feat.shape[1]
    valid = valid.to(feat.device)
    mask = (torch.arange(t, device=feat.device)[None, :, None]
            < valid[:, None, None]).to(feat.dtype)
    count = torch.clamp_min(valid.to(feat.dtype), 1.0)[:, None, None]
    mean = torch.sum(feat * mask, dim=1, keepdim=True) / count
    var = torch.sum((feat - mean) ** 2 * mask, dim=1, keepdim=True) / count
    std = torch.sqrt(var)
    std = torch.where(std == 0.0, torch.ones_like(std), std)
    out = (feat - mean) / std
    # sklearn.scale re-centres after scaling so a near-constant column (an
    # empty mel filter) does not keep a spurious mean from round-off
    mean2 = torch.sum(out * mask, dim=1, keepdim=True) / count
    return (out - mean2) * mask


# csrc/fbank.cu's constants: threads a block, bins a pass, the shared
# memory a block may use
CMVN_THREADS, CMVN_CHUNK, SMEM_LIMIT = 512, 256, 232448


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def cmvn_plan(t: int, f: int, cluster: int) -> dict:
    """The ``cmvn`` kernel's tiling for T frames of F bins on clusters of
    ``cluster`` blocks (``asr_cmvn_plan`` fields 1-5; the launcher picks 16,
    or 8 where the card cannot place 16): rows a block, bins a pass, row
    groups a bin, whether the rows stream from device memory (else one
    block's rows sit in its shared memory) and the shared bytes a block."""
    rows = -(-t // cluster)
    chunk = min(f, CMVN_CHUNK)
    groups = max(1, CMVN_THREADS // chunk)
    pad = -(-chunk // 4) * 4
    fixed = 32 + _round16(4 * ((3 + 2 * cluster) * pad + (groups + 3) * chunk))
    tile = _round16(4 * (rows * f + 3))
    stream = fixed + tile > SMEM_LIMIT
    return {"rows": rows, "chunk": chunk, "groups": groups,
            "stream": int(stream), "smem": fixed if stream else fixed + tile}


def cmvn_blocked_np(feat: np.ndarray, valid: np.ndarray,
                    cluster: int) -> np.ndarray:
    """The ``cmvn`` kernel's arithmetic in numpy f32, in its order of sums:
    block r of an utterance's cluster owns frames r * rows .. (``cmvn_plan``);
    thread (g, j) sums a statistic over the block's valid rows g, g + G, ..
    in four interleaved accumulators (the m-th of its rows into accumulator
    m % 4, each in order; then (a0 + a1) + (a2 + a3)), the block adds its G
    group sums in order, and the cluster adds the blocks' partials in rank
    order. Products and quotients are rounded on their own, as the
    kernel's (no FMA)."""
    b_total, t, f = feat.shape
    plan = cmvn_plan(t, f, cluster)
    rows, groups = plan["rows"], plan["groups"]
    out = np.zeros_like(feat, dtype=np.float32)
    for b in range(b_total):
        nv = int(valid[b])
        n_rows = max(0, min(nv, t))
        cnt = np.float32(max(nv, 1))
        x = feat[b].astype(np.float32)

        def total(term):
            tot = None
            for rank in range(cluster):
                r0 = min(rank * rows, t)
                n = max(0, min(r0 + rows, t, n_rows) - r0)
                part = None
                for g in range(groups):
                    acc = [np.zeros(f, np.float32) for _ in range(4)]
                    for m, r in enumerate(range(g, n, groups)):
                        acc[m % 4] = acc[m % 4] + term(x[r0 + r])
                    s = (acc[0] + acc[1]) + (acc[2] + acc[3])
                    part = s if part is None else part + s
                tot = part if tot is None else tot + part
            return tot

        mean = total(lambda v: v) / cnt
        sd = np.sqrt(total(lambda v: (v - mean) * (v - mean)) / cnt)
        sd = np.where(sd == 0, np.float32(1), sd).astype(np.float32)
        mean2 = total(lambda v: (v - mean) / sd) / cnt
        out[b, :n_rows] = (x[:n_rows] - mean) / sd - mean2
    return out


def _cmvn_cpu(feat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The op under ``cmvn``: the twin for CPU tensors."""
    return cmvn_reference(feat, valid)


def _cmvn_cuda(feat, valid):
    """The op under ``cmvn``: the kernel for CUDA tensors."""
    dev = _build.require_cuda("cmvn", feat, valid)
    b, t, f = feat.shape
    out = torch.empty_like(feat)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_cmvn(feat.data_ptr(), valid.data_ptr(), out.data_ptr(),
                          b, t, f, _build.stream_ptr(dev))
    _build.check("cmvn", rc)
    return out


def _cmvn_fake(feat, valid):
    return torch.empty_like(feat)


_cmvn_op = _build.define_op("cmvn", _cmvn_cpu, _cmvn_cuda, _cmvn_fake)


def cmvn(feat: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, T, F] f32 features + [B] int32 valid frame counts -> normalised
    [B, T, F]: per-utterance, per-bin masked mean/std (ddof 0, std 0 -> 1),
    a second re-centering, rows at/past ``valid`` zeroed."""
    if feat.dim() != 3 or feat.dtype != torch.float32:
        raise ValueError("cmvn: feat must be [B, T, F] float32, got "
                         f"{tuple(feat.shape)} {feat.dtype}")
    if valid.shape != (feat.shape[0],) or valid.dtype != torch.int32:
        raise ValueError("cmvn: valid must be [B] int32")
    _build.no_grad_inputs("cmvn", feat)
    _build.check_device("cmvn", feat, valid)
    return _cmvn_op(feat, valid)
