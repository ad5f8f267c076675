"""Building blocks: the port of ``asr_dfcnn_transformer_tpu.models.layers``.

Parameters are float32; each block computes in its ``dtype`` (bfloat16 on
the serving path), casting parameters at use, as the Flax modules do.
Submodule and parameter names mirror the Flax tree (``Conv_0``,
``BatchNorm_0``, ``Dense_0``, ``LayerNorm_0``, ``q``/``k``/``v``/``out``)
so ``convert.py`` maps one onto the other by name. Layouts are PyTorch's:
convolutions run NCHW, linear weights are [out, in].

Initialisation draws from an explicit ``torch.Generator`` on the CPU and
copies to ``device``; trained weights come through ``convert.py``. In
training mode (``.train()``) BatchNorm normalises with batch statistics and
updates its running ones, and dropout draws its keep masks from the
``generator`` a forward is given (on the tensor's device), as Flax draws
from its ``dropout`` rng.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from asr_dfcnn_transformer_torch.kernels import ffn as ffn_kernel
from asr_dfcnn_transformer_torch.kernels.attention import (BIG_NEG, MAX_DH,
                                                          masked_attention)
from asr_dfcnn_transformer_torch.kernels.dual_attention import (
    dual_axis_attention, supports as dual_supports)

BN_EPS = 1e-3      # every BatchNorm of the AM (layers.py ConvBnCell)
BN_MOMENTUM = 0.99  # Flax BatchNorm's default (ra = m * ra + (1 - m) * stat)
LN_EPS = 1e-6      # Flax LayerNorm's default, not torch's 1e-5
BACKENDS = ("auto", "pallas", "einsum")  # the JAX modules' ``fused`` values


# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's correction)
_TRUNC_STD = 0.87962566103423978


def _param(shape, std: float, generator: torch.Generator,
           device) -> nn.Parameter:
    """``nn.initializers.normal(std)`` (the embeddings)."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32) * std
    return nn.Parameter(w.to(device))


def _lecun_normal(shape, fan_in: int, generator: torch.Generator,
                  device) -> nn.Parameter:
    """``nn.initializers.lecun_normal()`` (every Dense and Conv kernel): a
    normal truncated at two of its standard deviations, scaled so that the
    variance is 1 / ``fan_in``."""
    s = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s,
                          generator=generator)
    return nn.Parameter(w.to(device))


def _const(shape, value: float, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


class Bf16Matmul(torch.autograd.Function):
    """``bf16_dot_general`` (layers.py:33) as ``nn.Dense`` applies it:
    y = x W^T with both operands rounded to bf16, the products summed and
    returned in f32. On the card one cuBLAS product with bf16 operands and
    an f32 output (``torch.mm(..., out_dtype=torch.float32)``); on the CPU
    its twin, an f32 product of the rounded operands (a product of two
    bf16 values is exact in f32). ``F.linear`` on bf16 tensors would
    round the result to bf16 as well: a different function.

    The backward is JAX's transpose of that product: each cotangent is an
    f32 product with the other rounded operand, rounded to bf16 (the
    operand's type inside the product), then cast to the operand's own
    dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.shapes = (x.shape, x.dtype, weight.dtype)
        if x.is_cuda:
            y = torch.mm(xb, wb.t(), out_dtype=torch.float32)
        elif x.device.type == "cpu":
            y = xb.float() @ wb.float().t()
        else:
            raise ValueError(f"bf16 logits head: no route for {x.device}")
        return y.reshape(*x.shape[:-1], weight.shape[0])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xb, wb = ctx.saved_tensors
        x_shape, x_dtype, w_dtype = ctx.shapes
        g2 = g.reshape(-1, g.shape[-1]).float()
        gx = (g2 @ wb.float()).to(torch.bfloat16).to(x_dtype)
        gw = (g2.t() @ xb.float()).to(torch.bfloat16).to(w_dtype)
        return gx.reshape(x_shape), gw


class Dense(nn.Module):
    """``nn.Dense``: y = x W^T (+ b) in ``dtype``; weight [out, in] f32.

    The bias is added after the product is rounded to ``dtype``, as Flax
    does, rather than inside the product as ``F.linear`` would.
    ``bf16_operands``: the product is :class:`Bf16Matmul` (Flax's
    ``dot_general=bf16_dot_general``), which returns f32, so ``dtype``
    must be f32."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: torch.dtype, device,
                 generator: torch.Generator, bf16_operands: bool = False):
        super().__init__()
        if bf16_operands and dtype != torch.float32:
            raise ValueError("bf16 operands return f32: dtype must be f32")
        self.dtype = dtype
        self.bf16_operands = bf16_operands
        self.weight = _lecun_normal((out_features, in_features),
                                    in_features, generator, device)
        self.bias = (nn.Parameter(_const((out_features,), 0.0, device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bf16_operands:
            y = Bf16Matmul.apply(x, self.weight)
        else:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def logits_dense(in_features: int, vocab_size: int, logits_matmul: str, *,
                 device, generator: torch.Generator) -> Dense:
    """The f32 logits projection of the AM family and the LM (dfcnn.py:40
    ``_logits_dense``): "f32" is a full f32 product, "bf16" rounds both
    operands to bf16 and sums in f32. The parameters are the same either
    way, so checkpoints are interchangeable across the setting."""
    if logits_matmul not in ("f32", "bf16"):
        raise ValueError(f"logits_matmul must be f32|bf16, "
                         f"got {logits_matmul!r}")
    return Dense(in_features, vocab_size, dtype=torch.float32, device=device,
                 generator=generator, bf16_operands=logits_matmul == "bf16")


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), padding="SAME")`` in NCHW for an odd
    ``kernel_size`` k; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = _lecun_normal((out_ch, in_ch, k, k), in_ch * k * k,
                                    generator, device)
        self.bias = nn.Parameter(_const((out_ch,), 0.0, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype),
                        padding=self.weight.shape[-1] // 2)


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1 with Flax's arithmetic:
    (x - mean) * (scale * rsqrt(var + eps)) + bias in f32, cast to dtype.

    Evaluation uses the running statistics. Training uses the batch's, as
    ``flax.linen.BatchNorm(use_running_average=False)`` computes them (f32,
    ``var = E[x^2] - E[x]^2`` clipped at 0), and updates the running ones
    with Flax's rule and the biased variance: ``ra = 0.99 ra + 0.01 stat``
    (not ``F.batch_norm``'s unbiased rule or its meaning of momentum)."""

    def __init__(self, features: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_const((features,), 1.0, device))
        self.bias = nn.Parameter(_const((features,), 0.0, device))
        self.register_buffer("running_mean", _const((features,), 0.0, device))
        self.register_buffer("running_var", _const((features,), 1.0, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if self.training:
            axes = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dim=axes)
            var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
            with torch.no_grad():
                self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                        + (1 - BN_MOMENTUM) * mean)
                self.running_var.copy_(BN_MOMENTUM * self.running_var
                                       + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(self.dtype)


def keep_mask(shape, keep_prob: float, device,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A bool keep mask: uniform [0, 1) draws below ``keep_prob``, as
    ``jax.random.bernoulli`` draws them (from ``generator``, on
    ``device``; None = torch's default generator)."""
    u = torch.rand(shape, generator=generator, device=device)
    return u < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``, active in training mode only:
    ``where(keep, x / keep_prob, 0)`` in x's dtype."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        keep = keep_mask(x.shape, 1.0 - self.rate, x.device, generator)
        # keep_prob rounded to x's dtype first, as JAX's weak typing rounds
        # it; a CPU 0-dim tensor acts as a scalar on any device, so no
        # blocking host -> device copy per call
        kp = torch.tensor(1.0 - self.rate, dtype=x.dtype)
        return torch.where(keep, x / kp, 0.0)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm`` (eps 1e-6): statistics in f32, output dtype."""

    def __init__(self, features: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(_const((features,), 1.0, device))
        self.bias = nn.Parameter(_const((features,), 0.0, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, LN_EPS)
        return y.to(self.dtype)


class ConvBnCell(nn.Module):
    """Conv3x3 -> ReLU -> BatchNorm, optional 2x2 pooling (layers.py:52).
    ``pool_type`` "avg" is the SE models' "maxpool" that average-pools.
    ``nin`` adds the plain DFCNN head's network-in-network insert before
    the pooling: Conv 1x1 (``nin_features``) -> ReLU -> BatchNorm -> Conv
    3x3 (``features``) -> ReLU -> BatchNorm, named ``Conv_1``,
    ``BatchNorm_1``, ``Conv_2``, ``BatchNorm_2`` as in Flax."""

    def __init__(self, in_ch: int, features: int, *, pool: bool = False,
                 pool_type: str = "max", nin: bool = False,
                 nin_features: int = 32, dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__()
        if pool_type not in ("max", "avg"):
            raise ValueError(f"unknown pool_type {pool_type!r}")
        self.pool = pool
        self.pool_type = pool_type
        self.nin = nin
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.Conv_0 = Conv(in_ch, features, **kw)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)
        if nin:
            self.Conv_1 = Conv(features, nin_features, 1, **kw)
            self.BatchNorm_1 = BatchNorm(nin_features, dtype=dtype,
                                         device=device)
            self.Conv_2 = Conv(nin_features, features, **kw)
            self.BatchNorm_2 = BatchNorm(features, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(F.relu(self.Conv_0(x)))
        if self.nin:
            x = self.BatchNorm_1(F.relu(self.Conv_1(x)))
            x = self.BatchNorm_2(F.relu(self.Conv_2(x)))
        if self.pool:
            pool = F.max_pool2d if self.pool_type == "max" else F.avg_pool2d
            x = pool(x, 2, 2)
        return x


class SqueezeExcite(nn.Module):
    """BN -> global average pool -> Dense(c/ratio) ReLU -> Dense(c)
    sigmoid -> channel scale (layers.py:94)."""

    def __init__(self, features: int, ratio: int = 2, *, dtype: torch.dtype,
                 device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        squeezed = max(features // ratio, 1)
        self.BatchNorm_0 = BatchNorm(features, dtype=dtype, device=device)
        self.Dense_0 = Dense(features, squeezed, dtype=dtype, device=device,
                             generator=generator)
        self.Dense_1 = Dense(squeezed, features, dtype=dtype, device=device,
                             generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(x)
        squeeze = x.float().mean(dim=(2, 3)).to(self.dtype)    # [B, C]
        e = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(squeeze))))
        return x * e[:, :, None, None]


class ScaledEmbed(nn.Module):
    """Token embedding with a zeroed PAD row and sqrt(d) scaling applied
    after the cast to ``dtype`` (layers.py:147)."""

    def __init__(self, vocab_size: int, features: int, *,
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        # sqrt(d) rounded to dtype, as Flax scales by it; the product of two
        # dtype values is exact in f32, so it rounds as a dtype multiply
        self.scale = torch.tensor(features ** 0.5, dtype=dtype).item()
        self.embedding = _param((vocab_size, features),
                                1.0 / math.sqrt(features), generator, device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.embedding)
        out = out.masked_fill((ids == 0)[..., None], 0.0).to(self.dtype)
        return out * self.scale


class LearnedPositionEmbed(nn.Module):
    """Learned absolute positions, ids clipped at max_length - 1
    (layers.py:170)."""

    def __init__(self, max_length: int, features: int, *,
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.max_length = max_length
        self.embedding = _param((max_length, features), 0.02, generator,
                                device)

    def forward(self, length: int) -> torch.Tensor:
        idx = torch.clamp(torch.arange(length, device=self.embedding.device),
                          max=self.max_length - 1)
        return self.embedding[idx].to(self.dtype)


def attention_mask(q_valid: torch.Tensor, k_valid: torch.Tensor,
                   causal: bool = False) -> torch.Tensor:
    """Additive [B, 1, Tq, Tk] mask from boolean validity vectors: 0 where
    attendable, -1e9 elsewhere (layers.py:188)."""
    mask = k_valid[:, None, None, :]
    if causal:
        tq, tk = q_valid.shape[-1], k_valid.shape[-1]
        mask = mask & torch.ones((tq, tk), dtype=torch.bool,
                                 device=k_valid.device).tril()
    return torch.where(mask, 0.0, BIG_NEG)


_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_attention(model: nn.Module):
    """Record the attention probabilities of every
    :class:`MultiHeadAttention` in ``model`` while the context is open:
    yields a dict {Flax module path ("block_0_attn",
    "encoder/block_0/self_attn", ...): [B, H, Tq, Tk] probabilities in
    the module's dtype, before dropout}, filled by the forwards run inside
    it (the first call of each module). While capturing, each module takes
    its plain branch, as the JAX module leaves its kernels under
    ``capture_intermediates``; outside a capture nothing changes."""
    names = {mod: name.replace(".", "/")
             for name, mod in model.named_modules()
             if isinstance(mod, MultiHeadAttention)}
    maps: Dict[str, torch.Tensor] = {}
    prev = getattr(_CAPTURE, "active", None)
    _CAPTURE.active = (names, maps)
    try:
        yield maps
    finally:
        _CAPTURE.active = prev


class MultiHeadAttention(nn.Module):
    """Multi-head attention with residual + LayerNorm (layers.py:203-383).
    ``parity``: ReLU'd, bias-free Q/K/V/out projections. The head split is
    head-major, ``[B, T, H, Dh]``.

    ``fused`` takes the JAX module's values ("auto", "pallas", "einsum";
    anything else raises). With "auto" or "pallas" the full-sequence
    forward routes as the JAX module's ``fused="pallas"`` does, without its
    TPU crossover: single-head, unmasked, non-causal, square (Tq == Tk),
    dropout-free attention (the e2e pre-net's rows, in serving and in
    training) goes to ``kernels.dual_axis_attention`` (within its forward's
    T <= 160, C <= 128 and, when a gradient is to flow, its backward's
    shared memory); every other head of Dh <= 128 to
    ``kernels.masked_attention``. Each is an autograd Function over a CUDA
    kernel on the card and its twin on the CPU. Heads wider than 128, and
    every head with "einsum", take the JAX module's einsum branch in plain
    torch (layers.py:305-306, :333-358), on the CPU as on the card. In
    training, ``dropout_rate`` drops attention probabilities: through a
    keep mask [B, H, Tq, Tk] that the masked kernel applies
    (layers.py:321-330), or in the plain branch as ``Dropout`` does.

    ``project_q`` / ``project_kv`` / ``attend_step`` are the pieces of the
    KV-cached decode, plain torch as in the JAX package."""

    def __init__(self, d_model: int, num_heads: int, *,
                 dropout_rate: float = 0.0, parity: bool = False,
                 fused: str = "auto", dtype: torch.dtype, device,
                 generator: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide into num_heads")
        if fused not in BACKENDS:
            raise ValueError(f"unknown attention backend {fused!r}")
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.parity = parity
        self.fused = fused
        self.dtype = dtype
        kw = dict(bias=not parity, dtype=dtype, device=device,
                  generator=generator)
        self.q = Dense(d_model, d_model, **kw)
        self.k = Dense(d_model, d_model, **kw)
        self.v = Dense(d_model, d_model, **kw)
        self.out = Dense(d_model, d_model, **kw)
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype, device=device)
        self.dropout = Dropout(dropout_rate)

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        return F.relu(y) if self.parity else y

    def _heads(self, y: torch.Tensor) -> torch.Tensor:
        b, t, _ = y.shape
        return y.view(b, t, self.num_heads, -1).transpose(1, 2).contiguous()

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._act(self.q(x))

    def project_kv(self, x: torch.Tensor):
        """[B, T, D] -> (k, v), both [B, T, D] (before the head split)."""
        return self._act(self.k(x)), self._act(self.v(x))

    def _finish(self, out: torch.Tensor, queries: torch.Tensor
                ) -> torch.Tensor:
        return self.LayerNorm_0(self._act(self.out(out)) + queries)

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                values: Optional[torch.Tensor] = None, *,
                k_valid: Optional[torch.Tensor] = None,
                causal: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``k_valid`` [B, Tk] bool + ``causal``: the structured form of
        ``attention_mask(q_valid, k_valid, causal)``. ``generator`` draws
        the dropout keep mask in training."""
        if values is None:
            values = keys
        b, tq, _ = queries.shape
        tk = keys.shape[1]
        dropout_on = self.training and self.dropout_rate > 0.0
        q = self.project_q(queries)
        k, v = self._act(self.k(keys)), self._act(self.v(values))
        capture = getattr(_CAPTURE, "active", None)
        record = None
        if capture is not None and self in capture[0]:
            name, maps = capture[0][self], capture[1]
            record = lambda p: maps.setdefault(name, p)   # noqa: E731
        if (record is not None or self.fused == "einsum"
                or self.d_model // self.num_heads > MAX_DH):
            out = self._plain(q, k, v, k_valid, causal, generator, record)
            return self._finish(out, queries)
        grad = torch.is_grad_enabled() and any(x.requires_grad
                                               for x in (q, k, v))
        if (self.num_heads == 1 and k_valid is None and not causal
                and tq == tk and not dropout_on
                and dual_supports(tk, self.d_model, q.dtype, grad)):
            out = dual_axis_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous())
            return self._finish(out, queries)
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        drop, keep = None, 1.0
        if dropout_on:
            keep = 1.0 - self.dropout_rate
            drop = keep_mask((b, self.num_heads, tq, tk), keep, q.device,
                             generator)
        out = masked_attention(q, k, v, k_valid, causal=causal,
                               keep_mask=drop, keep_prob=keep)
        out = out.transpose(1, 2).reshape(b, tq, self.d_model)
        return self._finish(out, queries)

    def _plain(self, q, k, v, k_valid, causal, generator, record=None):
        """The JAX module's einsum branch on projected q [B, Tq, D], k / v
        [B, Tk, D]: f32 scores divided by sqrt(Dh), the additive
        ``attention_mask``, f32 softmax, probabilities in the dtype (handed
        to ``record`` when given), then dropped, then P.V -> [B, Tq, D]."""
        b, tq, _ = q.shape
        dh = self.d_model // self.num_heads
        q, k, v = self._heads(q), self._heads(k), self._heads(v)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(dh)
        if k_valid is not None or causal:
            kv = k_valid if k_valid is not None else torch.ones(
                (b, k.shape[2]), dtype=torch.bool, device=q.device)
            scores = scores + attention_mask(
                torch.ones((b, tq), dtype=torch.bool, device=q.device), kv,
                causal)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        if record is not None:
            record(probs)
        probs = self.dropout(probs, generator)
        out = torch.matmul(probs.float(), v.float()).to(self.dtype)
        return out.transpose(1, 2).reshape(b, tq, self.d_model)

    def attend_step(self, query_t: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, valid_len) -> torch.Tensor:
        """One cached position (layers.py:360), as the JAX code computes
        it: f32 scores DIVIDED by sqrt(Dh), keys at or past ``valid_len``
        REPLACED by -1e9, f32 softmax, probabilities in the dtype before
        P.V. query_t [B, 1, D]; k_cache / v_cache [B, Tmax, D] (projected);
        valid_len an int or a [B] tensor. Returns [B, 1, D] (residual and
        LayerNorm applied)."""
        b = query_t.shape[0]
        tk = k_cache.shape[1]
        h, dh = self.num_heads, self.d_model // self.num_heads
        q = self.project_q(query_t).view(b, 1, h, dh).transpose(1, 2)
        k = k_cache.view(b, tk, h, dh).transpose(1, 2)
        v = v_cache.view(b, tk, h, dh).transpose(1, 2)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(dh)
        pos = torch.arange(tk, device=k_cache.device)
        if isinstance(valid_len, torch.Tensor) and valid_len.dim() == 1:
            key_ok = pos[None, :] < valid_len[:, None]
        else:
            key_ok = (pos < valid_len)[None, :]
        scores = torch.where(key_ok[:, None, None, :], scores, BIG_NEG)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        out = torch.matmul(probs.float(), v.float()).to(self.dtype)
        out = out.transpose(1, 2).reshape(b, 1, self.d_model)
        return self._finish(out, query_t)


class FeedForward(nn.Module):
    """relu(x W1 + b1) W2 + b2, dropout (training only), residual,
    LayerNorm (layers.py:403); parameters under Dense_0 / Dense_1 whatever
    the backend, so checkpoints are shared. ``fused``: "pallas" runs the
    ``kernels.fused_ffn`` kernel (its twin on the CPU), in training too, as
    the JAX module's "pallas" does; "auto" and "einsum" run the two
    ``Dense`` layers (no H100 crossover is measured, and the JAX "auto"
    never picks the kernel either: ``ffn_wins``); anything else raises, and
    so does a width the kernel cannot take with "pallas". The LM builds its
    FFNs with the default rate 0, the e2e model with its
    ``dropout_rate``."""

    def __init__(self, d_model: int, inner: Optional[int] = None, *,
                 dropout_rate: float = 0.0, fused: str = "auto",
                 dtype: torch.dtype, device, generator: torch.Generator):
        super().__init__()
        if fused not in BACKENDS:
            raise ValueError(f"unknown ffn backend {fused!r}")
        inner = inner or 4 * d_model
        if fused == "pallas":
            ffn_kernel.check_supported(d_model, inner)
        self.fused = fused
        self.dtype = dtype
        self.dropout = Dropout(dropout_rate)
        self.Dense_0 = Dense(d_model, inner, dtype=dtype, device=device,
                             generator=generator)
        self.Dense_1 = Dense(inner, d_model, dtype=dtype, device=device,
                             generator=generator)
        self.LayerNorm_0 = LayerNorm(d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fused == "pallas":
            y = ffn_kernel.fused_ffn(x.to(self.dtype), self.Dense_0.weight,
                                     self.Dense_0.bias, self.Dense_1.weight,
                                     self.Dense_1.bias)
        else:
            y = self.Dense_1(F.relu(self.Dense_0(x)))
        y = self.dropout(y, generator)
        return self.LayerNorm_0(y + x)


def label_smoothing(one_hot: torch.Tensor, epsilon: float = 0.1
                    ) -> torch.Tensor:
    """Uniform label smoothing (layers.py:456)."""
    v = one_hot.shape[-1]
    return (1.0 - epsilon) * one_hot + epsilon / v
