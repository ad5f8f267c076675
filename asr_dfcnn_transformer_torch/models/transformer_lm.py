"""Transformer-encoder LM, pinyin ids -> hanzi logits: the port of
``models/transformer_lm.py:41 TransformerLM`` and its ``lm_loss_and_acc``.

Scaled zero-PAD token embedding + learned positions (cap 100), then
``num_blocks`` self-attention + FFN blocks (two stacks of them with
``two_stack``), then an f32 projection to the hanzi vocabulary. Keys are
masked where the id is PAD, and causally by default (the reference's
language_model.py:48 quirk). In training mode, dropout at ``dropout_rate``
acts on the embeddings (transformer_lm.py:72) and on the attention
probabilities; the FFNs have none, as in the JAX LM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.layers import (Dropout, FeedForward,
                                                       LearnedPositionEmbed,
                                                       MultiHeadAttention,
                                                       ScaledEmbed,
                                                       label_smoothing,
                                                       logits_dense)


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    """The Flax ``TransformerLM``'s fields, name for name.
    ``dropout_rate`` acts in training only; ``logits_matmul`` is "f32" or
    "bf16" (bf16 operands summed in f32). ``fused_attention`` ("auto" | "pallas" | "einsum") goes to every
    block's ``MultiHeadAttention``: "auto" and "pallas" run the attention
    kernels, "einsum" the plain-torch branch. ``fused_ffn`` goes to every
    ``FeedForward``: "pallas" runs the ``fused_ffn`` kernel, "auto" and
    "einsum" the two Dense layers. Other values raise when the model is
    built."""

    input_vocab_size: int
    output_vocab_size: int
    d_model: int = 512
    num_heads: int = 8
    num_blocks: int = 12
    position_max_length: int = 100
    dropout_rate: float = 0.5
    causal: bool = True
    parity_attention: bool = True
    two_stack: bool = False
    logits_matmul: str = "f32"
    fused_attention: str = "auto"
    fused_ffn: str = "auto"
    dtype: torch.dtype = torch.bfloat16


class TransformerLM(nn.Module):
    def __init__(self, config: TransformerLMConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        """``device`` defaults to ``cuda`` (raises without CUDA: pass
        ``device="cpu"`` for the CPU)."""
        super().__init__()
        c = config
        self.config = c
        device = default_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        kw = dict(dtype=c.dtype, device=device, generator=gen)
        self.token_embed = ScaledEmbed(c.input_vocab_size, c.d_model, **kw)
        self.pos_embed = LearnedPositionEmbed(c.position_max_length,
                                              c.d_model, **kw)
        self.dropout = Dropout(c.dropout_rate)
        for s in range(self.n_stacks):
            for i in range(c.num_blocks):
                self.add_module(f"block{s}_{i}_attn", MultiHeadAttention(
                    c.d_model, c.num_heads, dropout_rate=c.dropout_rate,
                    parity=c.parity_attention, fused=c.fused_attention,
                    **kw))
                self.add_module(f"block{s}_{i}_ffn", FeedForward(
                    c.d_model, fused=c.fused_ffn, **kw))
        self.output = logits_dense(c.d_model, c.output_vocab_size,
                                   c.logits_matmul, device=device,
                                   generator=gen)

    @property
    def n_stacks(self) -> int:
        return 2 if self.config.two_stack else 1

    @property
    def position_max_length(self) -> int:
        return self.config.position_max_length

    def forward(self, ids: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """ids [B, T] pinyin ids (0 = PAD) -> [B, T, out_vocab] f32 logits.
        ``generator`` draws the dropout masks in training."""
        c = self.config
        valid = ids != constants.PAD
        x = self.token_embed(ids) + self.pos_embed(ids.shape[1])
        x = self.dropout(x, generator)
        for s in range(self.n_stacks):
            for i in range(c.num_blocks):
                x = getattr(self, f"block{s}_{i}_attn")(
                    x, x, k_valid=valid, causal=c.causal,
                    generator=generator)
                x = getattr(self, f"block{s}_{i}_ffn")(x)
        return self.output(x)


def lm_loss_and_acc(logits: torch.Tensor, targets: torch.Tensor,
                    epsilon: float = 0.1, reduce=None):
    """Label-smoothed softmax CE normalised by the non-PAD count, and the
    PAD-masked accuracy (transformer_lm.py:97-113). Returns f32 scalars
    (mean loss, accuracy). ``reduce`` (a trainer's sum over its ``data``
    group) makes the count the global batch's."""
    istarget = (targets != constants.PAD).float()
    one_hot = torch.nn.functional.one_hot(targets.long(),
                                          logits.shape[-1]).float()
    smoothed = label_smoothing(one_hot, epsilon)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    xent = -torch.sum(smoothed * log_probs, dim=-1)
    count = torch.sum(istarget)
    denom = torch.clamp_min(count if reduce is None else reduce(count), 1.0)
    mean_loss = torch.sum(xent * istarget) / denom
    preds = torch.argmax(logits, dim=-1)
    acc = torch.sum((preds == targets).float() * istarget) / denom
    return mean_loss, acc
