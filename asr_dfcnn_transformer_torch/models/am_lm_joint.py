"""The jointly trained AM -> LM: the port of ``models/am_lm_joint.py:34
AMLMJoint``.

One forward computes ``loss = CTC(AM logits, pinyin) + CE(LM(greedy
decode of the AM logits), hanzi)``: the LM trains on the AM's own greedy
pinyin, and the decode is outside autograd (JAX's ``stop_gradient``), so
the one backward crosses the LM and the AM's CTC, not the decode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.dfcnn import (SEDFCNN, SEDFCNNConfig,
                                                      logit_lengths)
from asr_dfcnn_transformer_torch.models.transformer_lm import (
    TransformerLM, TransformerLMConfig, lm_loss_and_acc)
from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss
from asr_dfcnn_transformer_torch.ops.ctc_decode import ctc_greedy_decode


@dataclasses.dataclass(frozen=True)
class AMLMJointConfig:
    """The Flax ``AMLMJoint``'s fields, name for name. ``small`` builds the
    reduced AM (stages 4, 4, 8, 8, 8, head 8, no dropout) and LM (d 32, 4
    heads, 1 block, no dropout) of the JAX module."""

    acoustic_vocab_size: int
    language_vocab_size: int
    lm_position_max_length: int = 100
    small: bool = False
    dtype: torch.dtype = torch.bfloat16


class AMLMJoint(nn.Module):
    def __init__(self, config: AMLMJointConfig, *, feature_dim: int = 200,
                 device=None, generator: Optional[torch.Generator] = None):
        """``feature_dim``: the AM's fbank filters. ``device`` defaults to
        ``cuda`` (raises without CUDA: pass ``device="cpu"``)."""
        super().__init__()
        c = self.config = config
        device = default_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        av, lv = c.acoustic_vocab_size, c.language_vocab_size
        if c.small:
            am = SEDFCNNConfig(av, stage_features=(4, 4, 8, 8, 8),
                               head_features=8, dropout_rate=0.0,
                               dtype=c.dtype)
            lm = TransformerLMConfig(
                av, lv, d_model=32, num_heads=4, num_blocks=1,
                dropout_rate=0.0,
                position_max_length=c.lm_position_max_length, dtype=c.dtype)
        else:
            am = SEDFCNNConfig(av, dtype=c.dtype)
            lm = TransformerLMConfig(
                av, lv, position_max_length=c.lm_position_max_length,
                dtype=c.dtype)
        self.am = SEDFCNN(am, feature_dim=feature_dim, device=device,
                          generator=gen)
        self.lm = TransformerLM(lm, device=device, generator=gen)

    def forward(self, feats: torch.Tensor, frame_lengths: torch.Tensor,
                pinyin: torch.Tensor, pinyin_lengths: torch.Tensor,
                hanzi: torch.Tensor, weights: Optional[torch.Tensor] = None,
                *, generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """feats [B, 1, T, F]; frame_lengths [B] valid fbank frames; pinyin
        [B, L], pinyin_lengths [B]; hanzi [B, Lh]; ``weights`` [B] (rows of
        weight 0 leave the AM's mean and their hanzi become PAD). Returns
        ``loss``, ``am_loss``, ``lm_loss``, ``lm_acc``, ``am_logits`` and
        ``decoded_pinyin`` [B, Lh] int32. ``generator`` draws the dropout
        masks in training."""
        am_logits = self.am(feats, generator=generator)
        in_len = logit_lengths(frame_lengths, am_logits.shape[1])
        losses = ctc_loss(am_logits, in_len, pinyin, pinyin_lengths,
                          blank_id=-1)
        if weights is None:
            am_loss = losses.mean()
        else:
            am_loss = torch.sum(losses * weights) / torch.clamp_min(
                weights.sum(), 1.0)
            hanzi = torch.where(weights[:, None] > 0, hanzi, 0)
        with torch.no_grad():
            dec, _ = ctc_greedy_decode(am_logits.detach(), in_len,
                                       blank_id=-1,
                                       max_output_len=hanzi.shape[1])
        lm_logits = self.lm(dec.to(torch.int64), generator=generator)
        lm_loss, lm_acc = lm_loss_and_acc(lm_logits, hanzi)
        return {"loss": am_loss + lm_loss, "am_loss": am_loss,
                "lm_loss": lm_loss, "lm_acc": lm_acc, "am_logits": am_logits,
                "decoded_pinyin": dec}
