"""End-to-end speech Transformer, LFR fbank -> hanzi: the port of
``models/speech_transformer.py``.

- **Pre-net**: two 3x3 stride-2 conv (tanh) + BatchNorm stages, then two
  residual dual-axis attention blocks (time rows and frequency rows of the
  [B, T', F', C] map, each a single-head attention, concatenated and
  projected back by a 3x3 conv + LayerNorm).
- **Encoder**: flatten (f-major, c-minor, as the NHWC original) + Dense +
  LayerNorm + learned positions; blocks of self-attention + FFN.
- **Decoder**: scaled embedding + learned positions; blocks of causal
  self-attention (none under ``parity_decoder``), cross-attention and FFN;
  an f32 projection to the vocabulary.
- **Decode**: KV-cached greedy and length-penalised beam search that run
  all ``max_len`` steps as the JAX ``lax.scan`` does (no early exit, no
  per-step host sync), their full-recompute oracles, and exact sequential
  ``microbatch`` chunking.
- **Training**: in training mode the pre-net's BatchNorms use and update
  batch statistics, the seven dropout sites draw from the ``generator``
  the forward is given, and ``e2e_loss`` is the label-smoothed CE over
  targets != IGNORE_ID.

Public layouts are the JAX package's: features [B, T, F, 1], ids int32.
The convolutions run NCHW inside the pre-net with XLA's SAME padding made
explicit; the dual blocks work channels-last, so their LayerNorm normalises
over C. The pre-net's frequency rows (single-head, unmasked, square) run the
``dual_axis_attention`` kernel; its masked time rows and the encoder's and
the full decoder's attention run ``masked_attention`` (heads wider than 128,
or ``fused_attention`` / ``prenet_fused`` "einsum": the plain branch of
``MultiHeadAttention``); the cached decode step's attention is plain torch,
as the JAX package's einsums. With ``fused_ffn="pallas"`` every FFN, the
cached step's too, runs the ``fused_ffn`` kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.layers import (BatchNorm, Dense,
                                                       Dropout, FeedForward,
                                                       LayerNorm,
                                                       LearnedPositionEmbed,
                                                       MultiHeadAttention,
                                                       ScaledEmbed, _const,
                                                       _lecun_normal,
                                                       label_smoothing)

NEG_INF = -1e30     # the beam's dead-candidate score (speech_transformer.py)
TIME_REDUCTION = 4  # two stride-2 convolutions


@dataclasses.dataclass(frozen=True)
class SpeechTransformerConfig:
    """The Flax ``SpeechTransformer``'s fields, name for name.
    ``dropout_rate`` acts in training only. The backend selectors take the
    JAX values and raise on others when the model is built:
    ``prenet_fused`` (the pre-net's dual-axis attention) and
    ``fused_attention`` (the encoder's and decoder's) as
    ``MultiHeadAttention.fused``; ``fused_ffn`` as ``FeedForward.fused``
    ("pallas" runs the ``fused_ffn`` kernel); ``prenet_conv1_layout``
    ("auto" | "plain" | "pack") as ``Stride2Conv.layout``: the port runs
    the plain stride-2 convolution for all three."""

    vocab_size: int
    d_model: int = 512
    num_heads: int = 8
    num_enc_blocks: int = 6
    num_dec_blocks: int = 6
    prenet_channels: int = 64
    prenet_heads: int = 1
    prenet_fused: str = "auto"
    prenet_conv1_layout: str = "auto"
    fused_attention: str = "auto"
    fused_ffn: str = "auto"
    dropout_rate: float = 0.1
    position_max_length: int = 512
    parity_decoder: bool = False
    prenet_masked: bool = True
    dtype: torch.dtype = torch.bfloat16


def same_pads(n: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (low, high) of one extent for a 3-tap window: at
    stride 2 it is (0, 1) on an even extent and (1, 1) on an odd one."""
    out = -(-n // stride)
    total = max((out - 1) * stride + 3 - n, 0)
    return total // 2, total - total // 2


class SameConv(nn.Module):
    """``nn.Conv(features, (3, 3), strides, padding="SAME")`` in NCHW:
    explicit SAME padding, then the convolution in ``dtype`` and the bias
    added after it, as Flax adds it. Weight OIHW."""

    def __init__(self, in_ch: int, features: int, stride: int = 1, *,
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.weight = _lecun_normal((features, in_ch, 3, 3), in_ch * 9,
                                    generator, device)
        self.bias = nn.Parameter(_const((features,), 0.0, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t_lo, t_hi = same_pads(x.shape[2], self.stride)
        f_lo, f_hi = same_pads(x.shape[3], self.stride)
        x = F.pad(x.to(self.dtype), (f_lo, f_hi, t_lo, t_hi))
        y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride)
        return y + self.bias.to(self.dtype)[None, :, None, None]


class Stride2Conv(SameConv):
    """The pre-net's 3x3 stride-2 SAME convolution (speech_transformer.py
    :111). ``layout`` takes the JAX values "auto" | "plain" | "pack" and
    raises on others; all three run the plain convolution here: "pack" is
    an exact re-expression of the same convolution in a layout for the
    TPU's matrix unit (space-to-depth, the same taps and parameters), and
    the JAX "auto" resolves to "plain"."""

    def __init__(self, in_ch: int, features: int, *, layout: str = "auto",
                 dtype: torch.dtype, device, generator: torch.Generator):
        if layout not in ("auto", "plain", "pack"):
            raise ValueError(f"layout must be auto|plain|pack, got "
                             f"{layout!r}")
        super().__init__(in_ch, features, 2, dtype=dtype, device=device,
                         generator=generator)


def _time_mask(t: int, t_valid: torch.Tensor) -> torch.Tensor:
    """[B, T] bool: frame < t_valid."""
    return torch.arange(t, device=t_valid.device)[None, :] < t_valid[:, None]


class DualAxisAttentionBlock(nn.Module):
    """Residual block attending over the time rows and the frequency rows
    of x [B, T, F, C] (channels-last) separately (speech_transformer.py:46).
    With ``t_valid`` [B], time keys at or past it are masked (the mask
    repeated per frequency, b-major) and invalid time rows are zeroed
    before the 3x3 conv and again in the output."""

    def __init__(self, channels: int, num_heads: int = 1, *,
                 fused: str = "auto", dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.time_attn = MultiHeadAttention(channels, num_heads, fused=fused,
                                            **kw)
        self.freq_attn = MultiHeadAttention(channels, num_heads, fused=fused,
                                            **kw)
        self.Conv_0 = SameConv(2 * channels, channels, **kw)
        self.LayerNorm_0 = LayerNorm(channels, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, f, c = x.shape
        time_in = x.transpose(1, 2).reshape(b * f, t, c)
        kv = tmask = None
        if t_valid is not None:
            tmask = _time_mask(t, t_valid)
            kv = tmask.repeat_interleave(f, dim=0)
        time_out = self.time_attn(time_in, time_in, k_valid=kv)
        time_out = time_out.reshape(b, f, t, c).transpose(1, 2)
        freq_in = x.reshape(b * t, f, c)
        freq_out = self.freq_attn(freq_in, freq_in).reshape(b, t, f, c)
        y = torch.cat([time_out, freq_out], dim=-1)
        if tmask is not None:
            y = torch.where(tmask[:, :, None, None], y, 0.0)
        y = self.Conv_0(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = x + self.LayerNorm_0(y)
        if tmask is not None:
            out = torch.where(tmask[:, :, None, None], out, 0.0)
        return out


class PreNet(nn.Module):
    """2x (stride-2 conv, tanh, BatchNorm) + dual-axis attention blocks
    (speech_transformer.py:175). [B, T, F, 1] -> [B, T/4, F/4, C]
    (ceil at each halving). ``fused`` goes to the blocks' attention,
    ``conv1_layout`` to the first convolution."""

    def __init__(self, channels: int = 64, num_attn_blocks: int = 2,
                 num_heads: int = 1, *, fused: str = "auto",
                 conv1_layout: str = "auto", dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.num_attn_blocks = num_attn_blocks
        self.Conv_0 = Stride2Conv(1, channels, layout=conv1_layout, **kw)
        self.BatchNorm_0 = BatchNorm(channels, dtype=dtype, device=device)
        self.Conv_1 = Stride2Conv(channels, channels, **kw)
        self.BatchNorm_1 = BatchNorm(channels, dtype=dtype, device=device)
        for i in range(num_attn_blocks):
            self.add_module(f"dual_{i}", DualAxisAttentionBlock(
                channels, num_heads, fused=fused, **kw))

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, F, 1]; ``valid`` [B] valid input frames (None: every
        frame attendable)."""
        h = torch.tanh(self.Conv_0(x.permute(0, 3, 1, 2)))
        h = self.BatchNorm_0(h)
        h = self.BatchNorm_1(torch.tanh(self.Conv_1(h)))
        h = h.permute(0, 2, 3, 1)                       # NHWC
        t_valid = None
        if valid is not None:
            t_valid = torch.clamp_min(torch.div(
                valid.to(h.device), TIME_REDUCTION, rounding_mode="floor"), 1)
        for i in range(self.num_attn_blocks):
            h = getattr(self, f"dual_{i}")(h, t_valid)
        return h


def _reduced(n: int) -> int:
    """An extent after the pre-net's two stride-2 convolutions."""
    half = -(-n // 2)
    return -(-half // 2)


class SpeechTransformer(nn.Module):
    """The e2e model. ``feature_dim`` is the width of an LFR row
    (``lfr_m`` x fbank bins: 4 x 80 = 320), which fixes ``enc_proj``'s
    input (the Flax module infers it at init). Submodules carry the Flax
    ``setup()`` names (``enc_attn_0``, ``dec_cross_0``, ...), so
    ``convert.e2e_state_dict`` maps one tree onto the other."""

    def __init__(self, config: SpeechTransformerConfig,
                 feature_dim: int = 320, *, device=None,
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
        d = c.d_model
        self.prenet = PreNet(c.prenet_channels, num_heads=c.prenet_heads,
                             fused=c.prenet_fused,
                             conv1_layout=c.prenet_conv1_layout, **kw)
        self.enc_proj = Dense(_reduced(feature_dim) * c.prenet_channels, d,
                              **kw)
        self.enc_ln = LayerNorm(d, dtype=c.dtype, device=device)
        self.enc_pos = LearnedPositionEmbed(c.position_max_length, d, **kw)
        self.enc_dropout = Dropout(c.dropout_rate)
        blocks = dict(dropout_rate=c.dropout_rate, **kw)
        attn = dict(fused=c.fused_attention, **blocks)
        ffn = dict(fused=c.fused_ffn, **blocks)
        for i in range(c.num_enc_blocks):
            self.add_module(f"enc_attn_{i}",
                            MultiHeadAttention(d, c.num_heads, **attn))
            self.add_module(f"enc_ffn_{i}", FeedForward(d, **ffn))
        self.dec_embed = ScaledEmbed(c.vocab_size, d, **kw)
        self.dec_pos = LearnedPositionEmbed(c.position_max_length, d, **kw)
        self.dec_dropout = Dropout(c.dropout_rate)
        for i in range(c.num_dec_blocks):
            if not c.parity_decoder:
                self.add_module(f"dec_self_{i}",
                                MultiHeadAttention(d, c.num_heads, **attn))
            self.add_module(f"dec_cross_{i}",
                            MultiHeadAttention(d, c.num_heads, **attn))
            self.add_module(f"dec_ffn_{i}", FeedForward(d, **ffn))
        self.dec_output = Dense(d, c.vocab_size, dtype=torch.float32,
                                device=device, generator=gen)

    def _block(self, name: str, i: int) -> nn.Module:
        return getattr(self, f"{name}_{i}")

    def forward(self, feats: torch.Tensor, feat_valid: torch.Tensor,
                dec_inputs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher forcing: feats [B, T, F, 1] LFR features, feat_valid [B]
        valid rows, dec_inputs [B, L] ids ([SOS] + y) -> [B, L, vocab] f32
        logits. In training mode ``generator`` draws every dropout mask
        (None: torch's default generator)."""
        memory, mem_valid = self.encode(feats, feat_valid, generator)
        return self.decode(memory, mem_valid, dec_inputs,
                           generator=generator)

    def encode(self, feats: torch.Tensor, feat_valid: torch.Tensor,
               generator: Optional[torch.Generator] = None):
        """-> (memory [B, T', d_model], mem_valid [B, T'] bool)."""
        x = self.prenet(feats,
                        feat_valid if self.config.prenet_masked else None)
        return self.encode_blocks(x, feat_valid, generator)

    def encode_blocks(self, x: torch.Tensor, feat_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None):
        """The encoder after the pre-net: x [B, T', F', C] -> (memory,
        mem_valid). A memory row is valid below max(feat_valid // 4, 1)."""
        c = self.config
        b, t, f, ch = x.shape
        x = self.enc_ln(self.enc_proj(x.reshape(b, t, f * ch)))
        x = self.enc_dropout(x + self.enc_pos(t), generator)
        mem_valid = _time_mask(t, torch.clamp_min(torch.div(
            feat_valid.to(x.device), TIME_REDUCTION, rounding_mode="floor"),
            1))
        for i in range(c.num_enc_blocks):
            x = self._block("enc_attn", i)(x, x, k_valid=mem_valid,
                                           generator=generator)
            x = self._block("enc_ffn", i)(x, generator)
        return x, mem_valid

    def decode(self, memory: torch.Tensor, mem_valid: torch.Tensor,
               dec_inputs: torch.Tensor, mask_pad: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full decoder over dec_inputs [B, L]. ``mask_pad`` (teacher
        forcing): PAD positions other than 0 are not attendable keys;
        False (autoregressive decoding): every position is, under the
        causal mask, as the cached ``decode_one`` attends them."""
        c = self.config
        ids = dec_inputs.to(torch.int64)
        b, l = ids.shape
        y = self.dec_dropout(self.dec_embed(ids) + self.dec_pos(l),
                             generator)
        if mask_pad:
            dec_valid = (ids != constants.PAD) | (
                torch.arange(l, device=ids.device)[None, :] == 0)
        else:
            dec_valid = torch.ones((b, l), dtype=torch.bool,
                                   device=ids.device)
        for i in range(c.num_dec_blocks):
            if not c.parity_decoder:
                y = self._block("dec_self", i)(y, y, k_valid=dec_valid,
                                               causal=True,
                                               generator=generator)
            y = self._block("dec_cross", i)(y, memory, k_valid=mem_valid,
                                            causal=c.parity_decoder,
                                            generator=generator)
            y = self._block("dec_ffn", i)(y, generator)
        return self.dec_output(y)

    def precompute_decode_state(self, memory: torch.Tensor):
        """Every cross-attention's K/V of the memory, stacked [n_dec, B,
        Tmem, D], and the position table [position_max_length, D]."""
        kv = [self._block("dec_cross", i).project_kv(memory)
              for i in range(self.config.num_dec_blocks)]
        return (torch.stack([k for k, _ in kv]),
                torch.stack([v for _, v in kv]),
                self.dec_pos(self.config.position_max_length))

    def decode_one(self, tok: torch.Tensor, pos, pos_row: torch.Tensor,
                   cross_k: torch.Tensor, cross_v: torch.Tensor,
                   self_k: torch.Tensor, self_v: torch.Tensor,
                   mem_len: torch.Tensor):
        """One cached step at position ``pos`` (an int, or a 0-d int64
        tensor, so that one traced program serves every step): tok [B]
        ids, pos_row [D], cross_k / cross_v [n_dec, B, Tmem, D], self_k /
        self_v [n_dec, B, Lmax, D] (row ``pos`` written in place; unused
        under ``parity_decoder``), mem_len [B] -> ([B, vocab] f32 logits,
        self_k, self_v)."""
        c = self.config
        y = self.dec_embed(tok.to(torch.int64)[:, None]) \
            + pos_row.to(c.dtype)[None, None, :]
        # reference parity: a causal (dec x memory) mask lets step ``pos``
        # see memory rows <= pos
        cross_len = torch.clamp(mem_len, max=pos + 1) if c.parity_decoder \
            else mem_len
        for i in range(c.num_dec_blocks):
            if not c.parity_decoder:
                attn = self._block("dec_self", i)
                kt, vt = attn.project_kv(y)
                _put_(self_k[i], 1, pos, kt[:, 0])
                _put_(self_v[i], 1, pos, vt[:, 0])
                y = attn.attend_step(y, self_k[i], self_v[i], pos + 1)
            y = self._block("dec_cross", i).attend_step(y, cross_k[i],
                                                        cross_v[i], cross_len)
            y = self._block("dec_ffn", i)(y)
        return self.dec_output(y)[:, 0], self_k, self_v


def e2e_loss(logits: torch.Tensor, targets: torch.Tensor,
             epsilon: float = 0.1, reduce=None):
    """Label-smoothed CE over the positions whose target is not IGNORE_ID
    (speech_transformer.py:389), and the accuracy over the same positions:
    logits [B, L, V], targets [B, L] -> f32 scalars (loss, acc). ``reduce``
    sums the count over a trainer's ``data`` group."""
    valid = (targets != constants.IGNORE_ID).float()
    safe = torch.clamp_min(targets.long(), 0)
    one_hot = F.one_hot(safe, logits.shape[-1]).float()
    smoothed = label_smoothing(one_hot, epsilon)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    xent = -torch.sum(smoothed * log_probs, dim=-1)
    count = torch.sum(valid)
    denom = torch.clamp_min(count if reduce is None else reduce(count), 1.0)
    loss = torch.sum(xent * valid) / denom
    acc = torch.sum((torch.argmax(logits, dim=-1) == safe).float()
                    * valid) / denom
    return loss, acc


# ---------------------------------------------------------------- decoding

def _length_penalty(length: torch.Tensor, alpha: float) -> torch.Tensor:
    return ((5.0 + length) / 6.0) ** alpha


def _finalize_greedy(tokens: torch.Tensor):
    """Emitted [B, L+1] tokens (with the [SOS] column) -> (ids [B, L] int32,
    PAD past the first EOS; lengths [B] int32)."""
    out = tokens[:, 1:]
    seen = torch.cumsum((out == constants.EOS).int(), dim=1) > 0
    lengths = (~seen).sum(dim=1).to(torch.int32)
    return torch.where(seen, constants.PAD, out).to(torch.int32), lengths


def _finalize_beam(tokens: torch.Tensor, logp: torch.Tensor,
                   lp_alpha: float):
    """Beam tokens [B, K, L+1] + final log-probs [B, K] -> (best ids [B, L]
    int32, lengths [B] int32, scores [B] f32) under the ((5+L)/6)^alpha
    length penalty; ``argmax`` takes the first best beam."""
    out = tokens[:, :, 1:]
    seen = torch.cumsum((out == constants.EOS).int(), dim=2) > 0
    lengths = (~seen).sum(dim=2)                                # [B, K]
    score = logp / _length_penalty(lengths.float(), lp_alpha)
    best = torch.argmax(score, dim=1)
    rows = torch.arange(out.shape[0], device=out.device)
    ids = torch.where(seen, constants.PAD, out)[rows, best]
    return (ids.to(torch.int32), lengths[rows, best].to(torch.int32),
            score[rows, best])


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: a stable descending sort keeps
    equal values in index order, so ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _init_tokens(shape, device) -> torch.Tensor:
    tokens = torch.full(shape, constants.PAD, dtype=torch.int64,
                        device=device)
    # fill_ of a scalar, not item assignment: on the CPU, PyTorch traces
    # ``t[i] = scalar`` through a CPU tensor of the scalar, elsewhere
    # through ``scalar_tensor``, and an exported program would differ by
    # the device it was traced on
    tokens[..., 0].fill_(constants.SOS)
    return tokens


def _margin(values: torch.Tensor, k: int) -> torch.Tensor:
    """[B] the gap between the k-th and the (k+1)-th largest of each row:
    which k survive may flip under a rounding difference smaller than it
    (their order may not change the result: the beams are kept by
    score)."""
    top = torch.topk(values, k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


def _take(x: torch.Tensor, dim: int, i) -> torch.Tensor:
    """x's index ``i`` along ``dim``; ``i`` an int or a 0-d int64 tensor."""
    if isinstance(i, torch.Tensor):
        return torch.index_select(x, dim, i.reshape(1)).squeeze(dim)
    return x.select(dim, i)


def _put_(x: torch.Tensor, dim: int, i, value: torch.Tensor) -> None:
    """x's index ``i`` along ``dim`` := value, in place (``i`` as in
    :func:`_take`)."""
    if isinstance(i, torch.Tensor):
        x.index_copy_(dim, i.reshape(1), value.unsqueeze(dim).to(x.dtype))
    else:
        x.select(dim, i).copy_(value)


def _pos_row(pos_table: torch.Tensor, i) -> torch.Tensor:
    """The position table's row min(i, rows - 1)."""
    last = pos_table.shape[0] - 1
    at = torch.clamp(i, max=last) if isinstance(i, torch.Tensor) \
        else min(i, last)
    return _take(pos_table, 0, at)


def greedy_start(model: SpeechTransformer, memory: torch.Tensor,
                 mem_valid: torch.Tensor, max_len: int):
    """The cached greedy loop before step 0 over an encoded batch ->
    (state, consts): state (tokens [B, L+1] with the [SOS] column,
    finished [B], self_k, self_v [n_dec, B, L, D]) changes every step;
    consts (cross_k, cross_v, the position table, mem_len [B]) do not."""
    c = model.config
    b = memory.shape[0]
    cross_k, cross_v, pos_table = model.precompute_decode_state(memory)
    mem_len = mem_valid.sum(dim=-1)
    self_k = torch.zeros((c.num_dec_blocks, b, max_len, c.d_model),
                         dtype=cross_k.dtype, device=memory.device)
    self_v = torch.zeros_like(self_k)
    tokens = _init_tokens((b, max_len + 1), memory.device)
    finished = torch.zeros(b, dtype=torch.bool, device=memory.device)
    return ((tokens, finished, self_k, self_v),
            (cross_k, cross_v, pos_table, mem_len))


def greedy_step(model: SpeechTransformer, state, consts, i):
    """Step ``i`` (an int, or a 0-d int64 tensor) of the cached greedy
    loop -> (state, the step's [B, vocab] logits)."""
    tokens, finished, self_k, self_v = state
    cross_k, cross_v, pos_table, mem_len = consts
    logits, self_k, self_v = model.decode_one(
        _take(tokens, 1, i), i, _pos_row(pos_table, i), cross_k, cross_v,
        self_k, self_v, mem_len)
    nxt = torch.where(finished, constants.PAD, torch.argmax(logits, -1))
    _put_(tokens, 1, i + 1, nxt)
    finished = finished | (nxt == constants.EOS)
    return (tokens, finished, self_k, self_v), logits


def _greedy_cached(model: SpeechTransformer, memory: torch.Tensor,
                   mem_valid: torch.Tensor, max_len: int,
                   margins: Optional[List[torch.Tensor]] = None):
    """The cached greedy loop over an encoded batch; ``margins`` (a list)
    collects each step's top-2 logit gap [B]."""
    state, consts = greedy_start(model, memory, mem_valid, max_len)
    for i in range(max_len):
        state, logits = greedy_step(model, state, consts, i)
        if margins is not None:
            margins.append(_margin(logits, 1))
    return _finalize_greedy(state[0])


def beam_start(model: SpeechTransformer, memory: torch.Tensor,
               mem_valid: torch.Tensor, beam_size: int, max_len: int):
    """The cached beam loop before step 0 over an encoded batch, beams on
    the batch axis -> (state, consts): state (tokens [B, K, L+1], logp
    [B, K], finished [B, K], self_k, self_v [n_dec, B*K, L, D]); consts
    (cross_k, cross_v, the position table, mem_len [B*K], the log-probs
    of a finished beam [vocab], each utterance's first beam row [B, 1])."""
    c = model.config
    k = beam_size
    b = memory.shape[0]
    dev = memory.device
    mem = memory.repeat_interleave(k, dim=0)
    mem_len = mem_valid.sum(dim=-1).repeat_interleave(k)
    cross_k, cross_v, pos_table = model.precompute_decode_state(mem)
    self_k = torch.zeros((c.num_dec_blocks, b * k, max_len, c.d_model),
                         dtype=cross_k.dtype, device=dev)
    self_v = torch.zeros_like(self_k)
    tokens = _init_tokens((b, k, max_len + 1), dev)
    # only beam 0 is live at the start
    logp = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                       NEG_INF)[None].repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    # a finished beam continues only with PAD, at no cost
    pad_only = torch.full((c.vocab_size,), NEG_INF, device=dev)
    pad_only[constants.PAD].fill_(0.0)       # as in _init_tokens
    rows = torch.arange(b, device=dev)[:, None] * k
    return ((tokens, logp, finished, self_k, self_v),
            (cross_k, cross_v, pos_table, mem_len, pad_only, rows))


def beam_step(model: SpeechTransformer, state, consts, i):
    """Step ``i`` (an int, or a 0-d int64 tensor) of the cached beam loop
    -> (state, the step's [B, K * vocab] candidate scores)."""
    tokens, logp, finished, self_k, self_v = state
    cross_k, cross_v, pos_table, mem_len, pad_only, rows = consts
    b, k = logp.shape
    logits, self_k, self_v = model.decode_one(
        _take(tokens.view(b * k, -1), 1, i), i, _pos_row(pos_table, i),
        cross_k, cross_v, self_k, self_v, mem_len)
    lp = torch.log_softmax(logits.float(), dim=-1).view(b, k, -1)
    v = lp.shape[-1]
    lp = torch.where(finished[..., None], pad_only, lp)
    cand = (logp[..., None] + lp).view(b, k * v)
    logp, top_idx = _top_k(cand, k)
    src = top_idx // v                                   # [B, K]
    sym = top_idx % v
    tokens = torch.gather(tokens, 1,
                          src[..., None].expand(-1, -1, tokens.shape[2]))
    _put_(tokens, 2, i + 1, sym)
    finished = torch.gather(finished, 1, src) | (sym == constants.EOS)
    # the self-attention caches follow the surviving beams
    flat_src = (rows + src).view(-1)
    self_k = self_k[:, flat_src]
    self_v = self_v[:, flat_src]
    return (tokens, logp, finished, self_k, self_v), cand


def _beam_cached(model: SpeechTransformer, memory: torch.Tensor,
                 mem_valid: torch.Tensor, beam_size: int, lp_alpha: float,
                 max_len: int, margins: Optional[List[torch.Tensor]] = None):
    """The cached beam loop over an encoded batch; ``margins`` (a list)
    collects each step's gap between the K-th and (K+1)-th best candidate
    [B]."""
    state, consts = beam_start(model, memory, mem_valid, beam_size, max_len)
    for i in range(max_len):
        state, cand = beam_step(model, state, consts, i)
        if margins is not None:
            margins.append(_margin(cand, beam_size))
    return _finalize_beam(state[0], state[1], lp_alpha)


def _microbatched(decode_fn: Callable, feats: torch.Tensor,
                  feat_valid: torch.Tensor, microbatch: Optional[int]):
    """``decode_fn(chunk_feats, chunk_valid)`` over sequential chunks of
    ``microbatch`` utterances, outputs concatenated. Exact: every
    utterance's decode is independent of the others'."""
    b = feats.shape[0]
    if microbatch is None or b <= microbatch:
        return decode_fn(feats, feat_valid)
    if b % microbatch != 0:
        raise ValueError(f"batch {b} not divisible by microbatch "
                         f"{microbatch}")
    outs = [decode_fn(feats[i:i + microbatch], feat_valid[i:i + microbatch])
            for i in range(0, b, microbatch)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


@torch.inference_mode()
def greedy_decode_cached(model: SpeechTransformer, feats: torch.Tensor,
                         feat_valid: torch.Tensor, max_len: int = 64,
                         microbatch: Optional[int] = None):
    """KV-cached greedy decode (speech_transformer.py:567): feats [B, T,
    F, 1], feat_valid [B] -> (ids [B, max_len] int32, lengths [B] int32).
    Cross-attention K/V are projected once; each step appends one row to
    the self-attention caches. ``microbatch``: decode in sequential chunks
    of that many utterances (exact)."""
    def run(f, v):
        memory, mem_valid = model.encode(f, v)
        return _greedy_cached(model, memory, mem_valid, max_len)
    return _microbatched(run, feats, feat_valid, microbatch)


@torch.inference_mode()
def beam_decode_cached(model: SpeechTransformer, feats: torch.Tensor,
                       feat_valid: torch.Tensor, beam_size: int = 3,
                       lp_alpha: float = 0.6, max_len: int = 64,
                       microbatch: Optional[int] = None):
    """KV-cached batched beam search (speech_transformer.py:436), beams on
    the batch axis -> (ids [B, max_len] int32, lengths [B] int32, scores
    [B] f32). ``microbatch`` as in :func:`greedy_decode_cached`."""
    def run(f, v):
        memory, mem_valid = model.encode(f, v)
        return _beam_cached(model, memory, mem_valid, beam_size, lp_alpha,
                            max_len)
    return _microbatched(run, feats, feat_valid, microbatch)


@torch.inference_mode()
def greedy_decode(model: SpeechTransformer, feats: torch.Tensor,
                  feat_valid: torch.Tensor, max_len: int = 64):
    """Full-recompute greedy decode (speech_transformer.py:512), the
    oracle of :func:`greedy_decode_cached`: every step runs the whole
    decoder over all positions."""
    memory, mem_valid = model.encode(feats, feat_valid)
    b = memory.shape[0]
    tokens = _init_tokens((b, max_len + 1), memory.device)
    finished = torch.zeros(b, dtype=torch.bool, device=memory.device)
    for i in range(max_len):
        logits = model.decode(memory, mem_valid, tokens[:, :-1],
                              mask_pad=False)
        nxt = torch.where(finished, constants.PAD,
                          torch.argmax(logits[:, i], dim=-1))
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == constants.EOS)
    return _finalize_greedy(tokens)


@torch.inference_mode()
def beam_decode(model: SpeechTransformer, feats: torch.Tensor,
                feat_valid: torch.Tensor, beam_size: int = 3,
                lp_alpha: float = 0.6, max_len: int = 64):
    """Full-recompute beam search (speech_transformer.py:625), the oracle
    of :func:`beam_decode_cached`."""
    k = beam_size
    memory, mem_valid = model.encode(feats, feat_valid)
    b = memory.shape[0]
    dev = memory.device
    mem = memory.repeat_interleave(k, dim=0)
    mvalid = mem_valid.repeat_interleave(k, dim=0)
    tokens = _init_tokens((b, k, max_len + 1), dev)
    logp = torch.where(torch.arange(k, device=dev) == 0, 0.0,
                       NEG_INF)[None].repeat(b, 1)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    pad_only = torch.full((model.config.vocab_size,), NEG_INF, device=dev)
    pad_only[constants.PAD] = 0.0
    for i in range(max_len):
        logits = model.decode(mem, mvalid, tokens.view(b * k, -1)[:, :-1],
                              mask_pad=False)
        lp = torch.log_softmax(logits[:, i].float(), dim=-1).view(b, k, -1)
        v = lp.shape[-1]
        lp = torch.where(finished[..., None], pad_only, lp)
        logp, top_idx = _top_k((logp[..., None] + lp).view(b, k * v), k)
        src = top_idx // v
        sym = top_idx % v
        tokens = torch.gather(tokens, 1,
                              src[..., None].expand(-1, -1, max_len + 1))
        tokens[:, :, i + 1] = sym
        finished = torch.gather(finished, 1, src) | (sym == constants.EOS)
    return _finalize_beam(tokens, logp, lp_alpha)
