"""The DFCNN acoustic-model family: the port of ``models/dfcnn.py``.

fbank [B, 1, T, F] (NCHW; the JAX package feeds NHWC [B, T, F, 1]) ->
pinyin CTC logits [B, T/8, vocab] f32, in three variants:

- :class:`SEDFCNN` (dfcnn.py:81): stage = pooled cell -> unpooled cell ->
  + SE (residual); the pooled cell's "maxpool" average-pools
  (acoustic_model2.py:115-117).
- :class:`DFCNN` (dfcnn.py:59): five max-pooled / plain cells, then a cell
  with the network-in-network insert.
- :class:`KerasDFCNN` (dfcnn.py:161): the Keras ``cnn_ctc`` layout whose
  ``.hdf5`` weights ``infer/hdf5_import.py`` loads: ten cells, Dense 128
  ReLU, then the logits head.

Each head reshapes channels-last, F major and C minor, as the NHWC original
does. The logits head is f32, or with ``logits_matmul="bf16"`` bf16
operands summed in f32 (``layers.logits_dense``). ``forward`` follows the
module's mode: in training the BatchNorms use batch statistics (and update
their running ones) and dropout acts before the dense layers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig, valid_frames
from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.layers import (ConvBnCell, Dense,
                                                       Dropout, SqueezeExcite,
                                                       logits_dense)


@dataclasses.dataclass(frozen=True)
class SEDFCNNConfig:
    """The Flax ``SEDFCNN``'s fields, name for name. ``dropout_rate`` acts
    in training only; ``remat_stages`` is not supported yet (it changes no
    value, only the backward's memory); ``logits_matmul`` is "f32" or
    "bf16"."""

    vocab_size: int
    stage_features: Sequence[int] = (32, 64, 128, 128, 128)
    stage_pool: Sequence[bool] = (True, True, True, False, False)
    se_ratio: Sequence[int] = (1, 2, 2, 2, 2)
    head_features: int = 256
    dropout_rate: float = 0.3
    se_first: bool = False
    space_to_depth: bool = False
    remat_stages: int = 0
    logits_matmul: str = "f32"
    dtype: torch.dtype = torch.bfloat16


class SEDFCNN(nn.Module):
    def __init__(self, config: SEDFCNNConfig, *, feature_dim: int = 200,
                 device=None, generator: Optional[torch.Generator] = None):
        """``feature_dim`` (F) sizes the logits head, which Flax infers from
        the first input. ``device`` defaults to ``cuda`` (raises without
        CUDA: pass ``device="cpu"`` for the CPU)."""
        super().__init__()
        c = config
        n = len(c.stage_features)
        if not len(c.stage_pool) == len(c.se_ratio) == n:
            raise ValueError("stage_features, stage_pool and se_ratio must "
                             "have one entry per stage")
        self.config = c
        device = default_device(device)
        gen = _generator(generator)
        kw = dict(dtype=c.dtype, device=device, generator=gen)
        in_ch, f = 1, feature_dim
        if c.space_to_depth:
            in_ch, f = 4, f // 2
        for idx, (feats, pool, ratio) in enumerate(
                zip(c.stage_features, c.stage_pool, c.se_ratio)):
            self.add_module(f"ConvBnCell_{2 * idx}", ConvBnCell(
                in_ch, feats, pool=pool, pool_type="avg", **kw))
            self.add_module(f"ConvBnCell_{2 * idx + 1}", ConvBnCell(
                feats, feats, pool=False, pool_type="avg", **kw))
            self.add_module(f"SqueezeExcite_{idx}",
                            SqueezeExcite(feats, ratio, **kw))
            in_ch = feats
            f = f // 2 if pool else f
        self.add_module(f"ConvBnCell_{2 * n}",
                        ConvBnCell(in_ch, c.head_features, **kw))
        self.dropout = Dropout(c.dropout_rate)
        self.Dense_0 = logits_dense(f * c.head_features, c.vocab_size,
                                    c.logits_matmul, device=device,
                                    generator=gen)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, 1, T, F] -> logits [B, T', vocab] float32. ``generator``
        draws the dropout mask in training."""
        c = self.config
        if c.space_to_depth:
            b, ch, t, f = x.shape
            x = x.reshape(b, ch, t // 2, 2, f // 2, 2)
            # channel order (row parity, column parity, c), as the NHWC
            # original's [b, t/2, f/2, 2, 2, c] reshape gives it
            x = x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * ch, t // 2,
                                                    f // 2)
        for idx in range(len(c.stage_features)):
            h = getattr(self, f"ConvBnCell_{2 * idx}")(x)
            cell2 = getattr(self, f"ConvBnCell_{2 * idx + 1}")
            se = getattr(self, f"SqueezeExcite_{idx}")
            x = h + cell2(se(h)) if c.se_first else h + se(cell2(h))
        x = getattr(self, f"ConvBnCell_{2 * len(c.stage_features)}")(x)
        return self.Dense_0(self.dropout(channels_last(x), generator))


def channels_last(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T, F] -> [B, T, F * C], F major and C minor, as the NHWC
    original reshapes [B, T, F, C]."""
    b, ch, t, f = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, f * ch)


# (features, pool) of the five cells of the plain and Keras layouts
_STAGES = ((32, True), (64, True), (128, True), (128, False), (128, False))


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


@dataclasses.dataclass(frozen=True)
class DFCNNConfig:
    """The Flax ``DFCNN``'s fields, name for name."""

    vocab_size: int
    dropout_rate: float = 0.3
    logits_matmul: str = "f32"
    dtype: torch.dtype = torch.bfloat16


class DFCNN(nn.Module):
    """Plain DFCNN (dfcnn.py:59): 32p/64p/128p/128/128 conv-BN cells
    (max-pooled) + a 256-channel cell with the NIN(32) insert, then
    dropout and the logits head."""

    def __init__(self, config: DFCNNConfig, *, feature_dim: int = 200,
                 device=None, generator: Optional[torch.Generator] = None):
        """``feature_dim`` (F) sizes the logits head, which Flax infers from
        the first input. ``device`` defaults to ``cuda`` (raises without
        CUDA: pass ``device="cpu"`` for the CPU)."""
        super().__init__()
        c = self.config = config
        device = default_device(device)
        gen = _generator(generator)
        kw = dict(dtype=c.dtype, device=device, generator=gen)
        in_ch, f = 1, feature_dim
        for idx, (feats, pool) in enumerate(_STAGES):
            self.add_module(f"ConvBnCell_{idx}",
                            ConvBnCell(in_ch, feats, pool=pool, **kw))
            in_ch, f = feats, f // 2 if pool else f
        self.ConvBnCell_5 = ConvBnCell(in_ch, 256, nin=True, nin_features=32,
                                       **kw)
        self.dropout = Dropout(c.dropout_rate)
        self.Dense_0 = logits_dense(f * 256, c.vocab_size, c.logits_matmul,
                                    device=device, generator=gen)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, 1, T, F] -> logits [B, T/8, vocab] float32."""
        for idx in range(len(_STAGES) + 1):
            x = getattr(self, f"ConvBnCell_{idx}")(x)
        return self.Dense_0(self.dropout(channels_last(x), generator))


@dataclasses.dataclass(frozen=True)
class KerasDFCNNConfig:
    """The Flax ``KerasDFCNN``'s fields, name for name."""

    vocab_size: int
    dense_units: int = 128
    dropout_rate: float = 0.3
    logits_matmul: str = "f32"
    dtype: torch.dtype = torch.bfloat16


class KerasDFCNN(nn.Module):
    """The Keras ``cnn_ctc`` layout (dfcnn.py:161, cnn_ctc.py:27-49): five
    double cells, the second of each max-pooled where the stage pools
    (``ConvBnCell_0..9``), reshape, Dropout, ``Dense_0`` (``dense_units``,
    in the model's dtype) ReLU, Dropout, then ``Dense_1``, the f32 logits
    head."""

    def __init__(self, config: KerasDFCNNConfig, *, feature_dim: int = 200,
                 device=None, generator: Optional[torch.Generator] = None):
        """As :class:`DFCNN`'s."""
        super().__init__()
        c = self.config = config
        device = default_device(device)
        gen = _generator(generator)
        kw = dict(dtype=c.dtype, device=device, generator=gen)
        in_ch, f = 1, feature_dim
        for idx, (feats, pool) in enumerate(_STAGES):
            self.add_module(f"ConvBnCell_{2 * idx}",
                            ConvBnCell(in_ch, feats, **kw))
            self.add_module(f"ConvBnCell_{2 * idx + 1}",
                            ConvBnCell(feats, feats, pool=pool, **kw))
            in_ch, f = feats, f // 2 if pool else f
        self.dropout = Dropout(c.dropout_rate)
        self.Dense_0 = Dense(f * in_ch, c.dense_units, **kw)
        self.Dense_1 = logits_dense(c.dense_units, c.vocab_size,
                                    c.logits_matmul, device=device,
                                    generator=gen)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, 1, T, F] -> logits [B, T/8, vocab] float32."""
        for idx in range(2 * len(_STAGES)):
            x = getattr(self, f"ConvBnCell_{idx}")(x)
        x = torch.relu(self.Dense_0(self.dropout(channels_last(x),
                                                 generator)))
        return self.Dense_1(self.dropout(x, generator))


def logit_lengths(frame_lengths: torch.Tensor,
                  max_logit_len: int = 200) -> torch.Tensor:
    """Valid CTC input length: min(cap, frames//8 + 1) (data_loader.py:132)."""
    return torch.clamp(torch.div(frame_lengths, 8, rounding_mode="floor") + 1,
                       max=max_logit_len).to(torch.int32)


def frames_from_samples(num_samples: torch.Tensor, win: int = 400,
                        hop: int = 160) -> torch.Tensor:
    """Exact fbank frame count per signal: 1 if S <= win else
    1 + ceil((S - win) / hop)."""
    return valid_frames(num_samples, FbankConfig(win_len=win, hop=hop))

