"""``log_mel`` and ``cmvn``: the front end's two kernels, each with its twin.

``log_mel`` replaces ``ops/pallas/fbank_kernel.py: pallas_log_mel`` and
``cmvn`` replaces ``pallas_cmvn``; the CUDA sources are ``csrc/fbank.cu``.
Each wrapper runs its plain-PyTorch twin (``*_reference``) for CPU tensors,
launches the kernel for CUDA tensors, and raises for anything else. Neither
has a backward: both raise when an input requires grad, rather than return
an output cut off from the graph.
"""

from __future__ import annotations

import functools

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
    """(cos [400, 257], sin [400, 257], mel [257, nfilt]) f32 on ``device``."""
    cos_b, sin_b = _dft_bases_np(cfg.win_len, cfg.nfft)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (cos_b, sin_b, mel_filterbank(cfg)))


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


def log_mel(signals: torch.Tensor, lengths: torch.Tensor, n_frames: int,
            cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[B, S] f32 raw signals + [B] int32 sample lengths -> [B, n_frames,
    nfilt] f32 log-mel. Pre-emphasis and the signal-end mask are applied
    inside; frames past the signal read zeros. The DFT sums run in f64
    (see csrc/fbank.cu), the rest in f32."""
    _check_geometry(cfg)
    if signals.dim() != 2 or signals.dtype != torch.float32:
        raise ValueError("log_mel: signals must be [B, S] float32, got "
                         f"{tuple(signals.shape)} {signals.dtype}")
    if lengths.shape != (signals.shape[0],) or lengths.dtype != torch.int32:
        raise ValueError("log_mel: lengths must be [B] int32")
    if n_frames < 1:
        raise ValueError(f"log_mel: n_frames must be >= 1, got {n_frames}")
    _build.no_grad_inputs("log_mel", signals)
    if signals.device.type == "cpu" and lengths.device.type == "cpu":
        return log_mel_reference(signals, lengths, n_frames, cfg)
    dev = _build.require_cuda("log_mel", signals, lengths)
    b, s = signals.shape
    cos_b, sin_b, mel = _bases(cfg, dev)
    out = torch.empty((b, n_frames, cfg.nfilt), device=dev,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        rc = lib.asr_log_mel(
            signals.data_ptr(), lengths.data_ptr(), cos_b.data_ptr(),
            sin_b.data_ptr(), mel.data_ptr(), out.data_ptr(), b, s,
            n_frames, cfg.nfilt, cfg.preemph, 1.0 / cfg.nfft,
            _build.stream_ptr(dev))
    _build.check("log_mel", rc)
    return out


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
    if feat.device.type == "cpu" and valid.device.type == "cpu":
        return cmvn_reference(feat, valid)
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
