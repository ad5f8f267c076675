"""The plain reference of the two acoustic models and the language model.

Plain PyTorch over a dict of named float32 tensors (the names and shapes are
``param_spec``'s, which are the port's ``state_dict`` names, so one set of
weights made by the benchmark loads into both). It follows the published
layers (SURVEY.md; ``lm_and_am/model/acoustic_model2.py``, ``cnn_ctc.py``,
``language_model.py``): every product goes through a ``Precision`` (f32, or
the fp8 control), everything else is float32.

- SE-DFCNN: per stage, a pooled cell (Conv3x3 -> ReLU -> BatchNorm, then a
  2x2 average pool where the stage pools), an unpooled cell, then the
  squeeze-excite block on the unpooled cell's output added to the pooled
  cell's; a last cell of ``head_features``; the [B, T', F * C] reshape (F
  major, C minor, as the NHWC original); dropout (training only); the
  logits head.
- KerasDFCNN: five stages of two cells, the second max-pooled where the stage
  pools; the reshape; dropout; Dense ``dense_units`` ReLU; dropout; the
  logits head.
- LM: the zero-PAD token embedding scaled by sqrt(d) plus learned positions,
  ``num_blocks`` blocks of (ReLU'd bias-free Q/K/V/out projections, key
  mask where the id is 0, causal mask, residual, LayerNorm) and (Dense 4d
  ReLU, Dense d, residual, LayerNorm), then the logits head. A row whose
  keys are all masked attends uniformly to every key, as an additive -1e9
  mask gives it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision

BN_EPS = 1e-3
LN_EPS = 1e-6
BIG_NEG = -1e9

Spec = List[Tuple[str, Tuple[int, ...], str, int]]


# ---- parameter specs: (name, shape, kind, fan_in) -----------------------

def _cell_spec(p: str, cin: int, cout: int) -> Spec:
    return [(f"{p}.Conv_0.weight", (cout, cin, 3, 3), "conv", cin * 9),
            (f"{p}.Conv_0.bias", (cout,), "bias", 0)] + _bn_spec(
                f"{p}.BatchNorm_0", cout, "_relu")


def _bn_spec(p: str, c: int, after: str = "") -> Spec:
    """``after`` "_relu": the BatchNorm follows a ReLU, whose output's
    statistics its running ones stand for."""
    return [(f"{p}.weight", (c,), "bn_weight", 0),
            (f"{p}.bias", (c,), "bn_bias", 0),
            (f"{p}.running_mean", (c,), "bn_mean" + after, 0),
            (f"{p}.running_var", (c,), "bn_var" + after, 0)]


def in_dtype(value: float, dtype: str) -> float:
    """A constant of the model as its compute dtype holds it (Flax rounds
    the dropout's keep probability and the embedding's sqrt(d) to the
    activations' dtype)."""
    return torch.tensor(value, dtype=getattr(torch, dtype)).item()


def _dense_spec(p: str, fin: int, fout: int, bias: bool = True) -> Spec:
    out = [(f"{p}.weight", (fout, fin), "dense", fin)]
    return out + ([(f"{p}.bias", (fout,), "bias", 0)] if bias else [])


def param_spec(kind: str, cfg: dict) -> Spec:
    """The named tensors of ``kind`` ("se_dfcnn", "keras_dfcnn" or "lm")
    under the configuration block ``cfg``."""
    if kind == "se_dfcnn":
        spec: Spec = []
        cin, f = 1, cfg["feature_dim"]
        for i, (c, pool, ratio) in enumerate(zip(
                cfg["stage_features"], cfg["stage_pool"], cfg["se_ratio"])):
            spec += _cell_spec(f"ConvBnCell_{2 * i}", cin, c)
            spec += _cell_spec(f"ConvBnCell_{2 * i + 1}", c, c)
            sq = max(c // ratio, 1)
            spec += _bn_spec(f"SqueezeExcite_{i}.BatchNorm_0", c)
            spec += _dense_spec(f"SqueezeExcite_{i}.Dense_0", c, sq)
            spec += _dense_spec(f"SqueezeExcite_{i}.Dense_1", sq, c)
            cin, f = c, f // 2 if pool else f
        n = len(cfg["stage_features"])
        spec += _cell_spec(f"ConvBnCell_{2 * n}", cin, cfg["head_features"])
        spec += _dense_spec("Dense_0", f * cfg["head_features"],
                            cfg["vocab_size"])
        return spec
    if kind == "keras_dfcnn":
        spec = []
        cin, f = 1, cfg["feature_dim"]
        for i, (c, pool) in enumerate(zip(cfg["stage_features"],
                                          cfg["stage_pool"])):
            spec += _cell_spec(f"ConvBnCell_{2 * i}", cin, c)
            spec += _cell_spec(f"ConvBnCell_{2 * i + 1}", c, c)
            cin, f = c, f // 2 if pool else f
        spec += _dense_spec("Dense_0", f * cin, cfg["dense_units"])
        spec += _dense_spec("Dense_1", cfg["dense_units"], cfg["vocab_size"])
        return spec
    if kind == "lm":
        d = cfg["d_model"]
        spec = [("token_embed.embedding", (cfg["input_vocab_size"], d),
                 "embed", d),
                ("pos_embed.embedding", (cfg["position_max_length"], d),
                 "pos", d)]
        for i in range(cfg["num_blocks"]):
            a = f"block0_{i}_attn"
            for w in ("q", "k", "v", "out"):
                spec += _dense_spec(f"{a}.{w}", d, d, bias=False)
            spec += [(f"{a}.LayerNorm_0.weight", (d,), "ln_weight", 0),
                     (f"{a}.LayerNorm_0.bias", (d,), "ln_bias", 0)]
            fn = f"block0_{i}_ffn"
            spec += _dense_spec(f"{fn}.Dense_0", d, 4 * d)
            spec += _dense_spec(f"{fn}.Dense_1", 4 * d, d)
            spec += [(f"{fn}.LayerNorm_0.weight", (d,), "ln_weight", 0),
                     (f"{fn}.LayerNorm_0.bias", (d,), "ln_bias", 0)]
        spec += _dense_spec("output", d, cfg["output_vocab_size"])
        return spec
    raise ValueError(f"no reference for model kind {kind!r}")


# ---- layers ---------------------------------------------------------------

def batch_norm(x, w: Dict[str, torch.Tensor], p: str, train: bool):
    """BatchNorm over channel axis 1: batch statistics in training (var =
    E[x^2] - E[x]^2, clipped at 0), the running ones otherwise."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dim=axes)
        var = torch.clamp_min((x * x).mean(dim=axes) - mean * mean, 0.0)
    else:
        mean, var = w[f"{p}.running_mean"], w[f"{p}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * w[f"{p}.weight"]
    return (x - mean.view(shape)) * mul.view(shape) + w[f"{p}.bias"].view(
        shape)


def conv_cell(x, w, p: str, pr: Precision, train: bool,
              pool: Optional[str] = None):
    x = F.relu(pr.conv(x, w[f"{p}.Conv_0.weight"], w[f"{p}.Conv_0.bias"]))
    x = batch_norm(x, w, f"{p}.BatchNorm_0", train)
    if pool == "avg":
        x = F.avg_pool2d(x, 2, 2)
    elif pool == "max":
        x = F.max_pool2d(x, 2, 2)
    return x


def dense(x, w, p: str, pr: Precision):
    return pr.linear(x, w[f"{p}.weight"], w.get(f"{p}.bias"))


def squeeze_excite(x, w, p: str, pr: Precision, train: bool):
    x = batch_norm(x, w, f"{p}.BatchNorm_0", train)
    s = x.mean(dim=(2, 3))
    e = torch.sigmoid(dense(F.relu(dense(s, w, f"{p}.Dense_0", pr)), w,
                            f"{p}.Dense_1", pr))
    return x * e[:, :, None, None]


def channels_last(x):
    b, c, t, f = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, t, f * c)


def dropout(x, keep: Optional[torch.Tensor], rate: float, dtype: str):
    if keep is None:
        return x
    return torch.where(keep, x / in_dtype(1.0 - rate, dtype), 0.0)


def se_dfcnn(w, cfg: dict, feats, pr: Precision, train: bool = False,
             keep: Optional[torch.Tensor] = None, dtype: str = "float32"):
    """feats [B, 1, T, F] -> logits [B, T', vocab]; ``keep``: the dropout
    keep mask before the head (training), its scale as ``dtype`` holds
    it."""
    x = feats.float()
    for i, pool in enumerate(cfg["stage_pool"]):
        h = conv_cell(x, w, f"ConvBnCell_{2 * i}", pr, train,
                      "avg" if pool else None)
        x = h + squeeze_excite(conv_cell(h, w, f"ConvBnCell_{2 * i + 1}", pr,
                                         train), w, f"SqueezeExcite_{i}",
                               pr, train)
    x = conv_cell(x, w, f"ConvBnCell_{2 * len(cfg['stage_pool'])}", pr, train)
    x = dropout(channels_last(x), keep, cfg["dropout_rate"], dtype)
    return dense(x, w, "Dense_0", pr)


def keras_dfcnn(w, cfg: dict, feats, pr: Precision, dtype: str = "float32"):
    """feats [B, 1, T, F] -> logits [B, T', vocab] (inference)."""
    x = feats.float()
    for i, pool in enumerate(cfg["stage_pool"]):
        x = conv_cell(x, w, f"ConvBnCell_{2 * i}", pr, False)
        x = conv_cell(x, w, f"ConvBnCell_{2 * i + 1}", pr, False,
                      "max" if pool else None)
    x = F.relu(dense(channels_last(x), w, "Dense_0", pr))
    return dense(x, w, "Dense_1", pr)


def acoustic_model(kind: str):
    return {"se_dfcnn": se_dfcnn, "keras_dfcnn": keras_dfcnn}[kind]


def layer_norm(x, w, p: str):
    return F.layer_norm(x, (x.shape[-1],), w[f"{p}.weight"], w[f"{p}.bias"],
                        LN_EPS)


def lm(w, cfg: dict, ids: torch.Tensor, pr: Precision,
       dtype: str = "float32"):
    """ids [B, T] (0 = PAD) -> hanzi logits [B, T, vocab] (inference)."""
    d, h = cfg["d_model"], cfg["num_heads"]
    dh = d // h
    b, t = ids.shape
    valid = ids != 0
    x = w["token_embed.embedding"][ids] * valid[..., None] * in_dtype(
        math.sqrt(d), dtype)
    pos = torch.clamp(torch.arange(t, device=ids.device),
                      max=cfg["position_max_length"] - 1)
    x = x + w["pos_embed.embedding"][pos]
    ok = valid[:, None, None, :] & torch.ones(
        (t, t), dtype=torch.bool, device=ids.device).tril()
    mask = torch.where(ok, 0.0, BIG_NEG)
    for i in range(cfg["num_blocks"]):
        a = f"block0_{i}_attn"
        q, k, v = (F.relu(dense(x, w, f"{a}.{n}", pr)).view(
            b, t, h, dh).transpose(1, 2) for n in ("q", "k", "v"))
        s = pr.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh) + mask
        o = pr.matmul(torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(b, t, d)
        x = layer_norm(F.relu(dense(o, w, f"{a}.out", pr)) + x, w,
                       f"{a}.LayerNorm_0")
        fn = f"block0_{i}_ffn"
        y = dense(F.relu(dense(x, w, f"{fn}.Dense_0", pr)), w,
                  f"{fn}.Dense_1", pr)
        x = layer_norm(y + x, w, f"{fn}.LayerNorm_0")
    return dense(x, w, "output", pr)
