"""CTC-attention, LFR fbank -> hanzi CTC logits in one model: the port of
``models/ctc_attention.py:36 CTCAttention``.

LFR features [B, T, F, 1] -> five ``ConvBnCell``s (32, 64, 128 max-pooled;
128, 128 not) -> channels last -> Dense ``bottleneck`` ReLU -> Dense
``d_model`` ReLU -> + learned positions -> dropout -> ``num_blocks`` blocks
of self-attention (no key mask: padded frames are attended, as in the JAX
model) and FFN (no dropout, as in the JAX model) -> the f32 ``output``
Dense over the hanzi vocabulary. Time is pooled by 8.

Lengths: ``valid_frames // 8 + 1`` capped at the logit rows (the pooled
geometry), or with ``parity_lengths`` the reference's ``ceil(valid / 4)``,
capped the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.dfcnn import channels_last
from asr_dfcnn_transformer_torch.models.layers import (ConvBnCell, Dense,
                                                       Dropout, FeedForward,
                                                       LearnedPositionEmbed,
                                                       MultiHeadAttention)

# (features, pool) of the five cells
_CELLS = ((32, True), (64, True), (128, True), (128, False), (128, False))


@dataclasses.dataclass(frozen=True)
class CTCAttentionConfig:
    """The Flax ``CTCAttention``'s fields, name for name. ``fused_attention``
    and ``fused_ffn`` go to every block, as in the LM."""

    vocab_size: int
    d_model: int = 512
    bottleneck: int = 32
    num_heads: int = 8
    num_blocks: int = 12
    position_max_length: int = 512
    dropout_rate: float = 0.1
    parity_attention: bool = True
    parity_lengths: bool = False
    fused_attention: str = "auto"
    fused_ffn: str = "auto"
    dtype: torch.dtype = torch.bfloat16


class CTCAttention(nn.Module):
    def __init__(self, config: CTCAttentionConfig, *, feature_dim: int = 800,
                 device=None, generator: Optional[torch.Generator] = None):
        """``feature_dim``: the LFR row width (m x fbank filters, 800 for
        the JAX trainer's 200 filters and m 4); it sizes ``Dense_0``, whose
        input width Flax infers from the first input. ``device`` defaults
        to ``cuda`` (raises without CUDA: pass ``device="cpu"``)."""
        super().__init__()
        c = self.config = config
        device = default_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        kw = dict(dtype=c.dtype, device=device, generator=gen)
        in_ch, f = 1, feature_dim
        for idx, (feats, pool) in enumerate(_CELLS):
            self.add_module(f"ConvBnCell_{idx}",
                            ConvBnCell(in_ch, feats, pool=pool, **kw))
            in_ch, f = feats, f // 2 if pool else f
        self.Dense_0 = Dense(f * in_ch, c.bottleneck, **kw)
        self.Dense_1 = Dense(c.bottleneck, c.d_model, **kw)
        self.pos_embed = LearnedPositionEmbed(c.position_max_length,
                                              c.d_model, **kw)
        self.dropout = Dropout(c.dropout_rate)
        for i in range(c.num_blocks):
            self.add_module(f"block_{i}_attn", MultiHeadAttention(
                c.d_model, c.num_heads, dropout_rate=c.dropout_rate,
                parity=c.parity_attention, fused=c.fused_attention, **kw))
            self.add_module(f"block_{i}_ffn", FeedForward(
                c.d_model, fused=c.fused_ffn, **kw))
        self.output = Dense(c.d_model, c.vocab_size, dtype=torch.float32,
                            device=device, generator=gen)

    def lengths(self, valid_frames: Optional[torch.Tensor], b: int, t: int,
                device) -> torch.Tensor:
        """Valid logit rows [B] int32 of ``valid_frames`` LFR rows."""
        if valid_frames is None:
            return torch.full((b,), t, dtype=torch.int32, device=device)
        v = valid_frames.to(torch.int64)
        n = -(-v // 4) if self.config.parity_lengths else v // 8 + 1
        return torch.clamp(n, max=t).to(torch.int32)

    def forward(self, x: torch.Tensor,
                valid_frames: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None):
        """x [B, T, F, 1] LFR features, valid_frames [B] -> (logits
        [B, T / 8, vocab] f32, valid logit rows [B] int32). ``generator``
        draws the dropout masks in training."""
        c = self.config
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for idx in range(len(_CELLS)):
            x = getattr(self, f"ConvBnCell_{idx}")(x)
        x = channels_last(x)
        b, t, _ = x.shape
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        x = self.dropout(x + self.pos_embed(t), generator)
        for i in range(c.num_blocks):
            x = getattr(self, f"block_{i}_attn")(x, x, generator=generator)
            x = getattr(self, f"block_{i}_ffn")(x, generator)
        logits = self.output(x)
        return logits, self.lengths(valid_frames, b, t, x.device)
