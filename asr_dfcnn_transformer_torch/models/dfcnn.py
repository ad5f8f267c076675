"""SE-DFCNN acoustic model: the port of ``models/dfcnn.py:81 SEDFCNN``.

fbank [B, 1, T, F] (NCHW; the JAX package feeds NHWC [B, T, F, 1]) ->
pinyin CTC logits [B, T/8, vocab] f32. Stage = pooled cell -> unpooled cell
-> + SE (residual); the pooled cell's "maxpool" average-pools
(acoustic_model2.py:115-117), and the head reshapes channels-last, F major
and C minor, as the NHWC original does. ``forward`` follows the module's
mode: in training the BatchNorms use batch statistics (and update their
running ones) and dropout acts before the logits head (dfcnn.py:156).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig, valid_frames
from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.layers import (ConvBnCell, Dense,
                                                       Dropout, SqueezeExcite)


@dataclasses.dataclass(frozen=True)
class SEDFCNNConfig:
    """The Flax ``SEDFCNN``'s fields, name for name. ``dropout_rate`` acts
    in training only; ``remat_stages`` is not supported yet (it changes no
    value, only the backward's memory); ``logits_matmul`` supports "f32"."""

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
        if c.logits_matmul != "f32":
            raise ValueError("the port computes the logits head in f32 only, "
                             f"got logits_matmul={c.logits_matmul!r}")
        n = len(c.stage_features)
        if not len(c.stage_pool) == len(c.se_ratio) == n:
            raise ValueError("stage_features, stage_pool and se_ratio must "
                             "have one entry per stage")
        self.config = c
        device = default_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
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
        self.Dense_0 = Dense(f * c.head_features, c.vocab_size,
                             dtype=torch.float32, device=device,
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
        b, ch, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * ch)   # F major, C minor
        return self.Dense_0(self.dropout(x, generator))


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

