"""BiGRU CTC acoustic model: the port of ``models/bigru.py`` (``KerasGRU``
:29, ``BiGRUCTC`` :84).

fbank [B, 1, T, F] (or [B, T, F]) -> Dense ``hidden`` ReLU x2 ->
``num_layers`` bidirectional GRU layers whose two directions are added ->
Dense ``hidden`` ReLU -> the logits head [B, T, vocab] f32. Time is not
pooled: the logits have one row a frame.

Two recurrences, as in the JAX package:

- the default, Flax's ``nn.RNN(nn.GRUCell)`` forward plus a time-aligned
  reversed one: ``r = sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) +
  hz(h))``, ``n = tanh(in(x) + r * hn(h))``, ``h = (1 - z) n + z h``, the
  gates in the model's dtype and the carry in f32 (Flax's carry is its
  ``param_dtype``). The cells carry Flax's names, ``GRUCell_{2i}``
  forward and ``GRUCell_{2i+1}`` backward, each with the Dense layers
  ``ir``, ``iz``, ``in`` (biased) and ``hr``, ``hz`` (not), ``hn``
  (biased). Dropout follows each dense layer and each GRU layer.
- ``keras_parity=True``, ``keras.layers.recurrent.GRU`` as the reference's
  ``cnn_rnn_ctc`` weights need it (:class:`KerasGRU`): gate order
  [z | r | h] in fused kernels, ``hard_sigmoid`` gates, the reset applied
  before the recurrent product, and the ``go_backwards`` layer's outputs
  left in processing order and added to the forward ones as they are.
  Always f32. Dropout precedes each dense and GRU layer.

Each layer's input projections for every step are one product hoisted out
of the time loop; the loop runs both directions of a layer together, one
batched product a step. The recurrence is plain PyTorch, as the JAX
package's is a ``lax.scan``: it has no Pallas kernel to port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from asr_dfcnn_transformer_torch.core.device import default_device
from asr_dfcnn_transformer_torch.models.layers import (_TRUNC_STD, Dense,
                                                       Dropout, logits_dense)


@dataclasses.dataclass(frozen=True)
class BiGRUCTCConfig:
    """The Flax ``BiGRUCTC``'s fields, name for name."""

    vocab_size: int
    hidden: int = 512
    num_layers: int = 3
    dropout_rate: float = 0.2
    keras_parity: bool = False
    logits_matmul: str = "f32"
    dtype: torch.dtype = torch.bfloat16


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Old Keras ``hard_sigmoid``: clip(0.2 x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _orthogonal(rows: int, cols: int, generator: torch.Generator,
                device) -> nn.Parameter:
    w = torch.empty((rows, cols), dtype=torch.float32)
    nn.init.orthogonal_(w, generator=generator)
    return nn.Parameter(w.to(device))


def _he_normal(rows: int, fan_in: int, generator: torch.Generator,
               device) -> nn.Parameter:
    """Flax ``he_normal``: a normal truncated at two standard deviations,
    variance 2 / ``fan_in``."""
    s = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    w = torch.empty((rows, fan_in), dtype=torch.float32)
    nn.init.trunc_normal_(w, std=s, a=-2.0 * s, b=2.0 * s,
                          generator=generator)
    return nn.Parameter(w.to(device))


class GRUCell(nn.Module):
    """Flax ``nn.GRUCell``'s parameters: Dense ``ir`` / ``iz`` / ``in``
    (input side, biased, lecun_normal) and ``hr`` / ``hz`` (no bias) /
    ``hn`` (biased) on the hidden side (orthogonal)."""

    def __init__(self, in_features: int, hidden: int, *, dtype: torch.dtype,
                 device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(in_features, hidden, **kw))
        for name in ("hr", "hz", "hn"):
            dense = Dense(hidden, hidden, bias=name == "hn", **kw)
            dense.weight = _orthogonal(hidden, hidden, generator, device)
            self.add_module(name, dense)

    def input_weights(self):
        """([3H, F] weight, [3H] bias) of the gates r, z, n."""
        d = [getattr(self, n) for n in ("ir", "iz", "in")]
        return (torch.cat([x.weight for x in d]),
                torch.cat([x.bias for x in d]))

    def hidden_weight(self) -> torch.Tensor:
        """[3H, H]: the hidden side of r, z, n."""
        return torch.cat([self.hr.weight, self.hz.weight, self.hn.weight])


class KerasGRU(nn.Module):
    """The parameters of ``keras.layers.recurrent.GRU`` (Flax ``KerasGRU``):
    ``weight`` is the Keras ``kernel`` [F, 3H] transposed, ``recurrent_weight``
    its ``recurrent_kernel`` [H, 3H] transposed, ``bias`` [3H]; gate order
    [z | r | h]."""

    def __init__(self, in_features: int, hidden: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.weight = _he_normal(3 * hidden, in_features, generator, device)
        self.recurrent_weight = _orthogonal(3 * hidden, hidden, generator,
                                            device)
        self.bias = nn.Parameter(torch.zeros(3 * hidden, device=device))


def _run_gru_pair(xp: torch.Tensor, w_h: torch.Tensor, step,
                  time_aligned: bool, carry_dtype: torch.dtype):
    """Both directions of one layer over time.

    xp [2, B, T, 3H]: the hoisted input projections, direction 0 forward
    and direction 1 backward (both indexed by frame); w_h [2, 3H, H] the
    hidden weights. Step k advances direction 0 at frame k and direction 1
    at frame T - 1 - k; ``step(h, xp_k, w_h)`` gives the new carry [2, B, H].
    Returns (forward [B, T, H], backward [B, T, H]): the backward outputs
    at the frame they were computed for (``time_aligned``) or in processing
    order (Keras ``go_backwards``)."""
    _, b, t, _ = xp.shape
    h = torch.zeros((2, b, w_h.shape[-1]), dtype=carry_dtype,
                    device=xp.device)
    outs = []
    for k in range(t):
        xk = torch.stack([xp[0, :, k], xp[1, :, t - 1 - k]])
        h = step(h, xk, w_h)
        outs.append(h)
    ys = torch.stack(outs, dim=2)                       # [2, B, T, H]
    bwd = ys[1].flip(1) if time_aligned else ys[1]
    return ys[0], bwd


class BiGRUCTC(nn.Module):
    def __init__(self, config: BiGRUCTCConfig, *, feature_dim: int = 200,
                 device=None, generator: Optional[torch.Generator] = None):
        """``feature_dim`` (F) sizes ``Dense_0``, whose input width Flax
        infers from the first input. ``device`` defaults to ``cuda`` (raises
        without CUDA: pass ``device="cpu"`` for the CPU)."""
        super().__init__()
        c = self.config = config
        device = default_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        h = c.hidden
        dt = torch.float32 if c.keras_parity else c.dtype
        kw = dict(dtype=dt, device=device, generator=gen)
        self.Dense_0 = Dense(feature_dim, h, **kw)
        self.Dense_1 = Dense(h, h, **kw)
        for i in range(c.num_layers):
            if c.keras_parity:
                self.add_module(f"gru_fwd_{i}", KerasGRU(
                    h, h, device=device, generator=gen))
                self.add_module(f"gru_bwd_{i}", KerasGRU(
                    h, h, device=device, generator=gen))
            else:
                self.add_module(f"GRUCell_{2 * i}", GRUCell(h, h, **kw))
                self.add_module(f"GRUCell_{2 * i + 1}", GRUCell(h, h, **kw))
        self.Dense_2 = Dense(h, h, **kw)
        self.Dense_3 = logits_dense(h, c.vocab_size, c.logits_matmul,
                                    device=device, generator=gen)
        self.dropout = Dropout(c.dropout_rate)

    def _layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The default path's GRU layer i: [B, T, H] -> fwd + bwd [B, T, H]
        f32 (the carry's dtype)."""
        dt = self.config.dtype
        cells = (getattr(self, f"GRUCell_{2 * i}"),
                 getattr(self, f"GRUCell_{2 * i + 1}"))
        xps, whs, bns = [], [], []
        hidden = self.config.hidden
        for cell in cells:
            w_i, b_i = cell.input_weights()
            # each Dense's product in the dtype, then its bias in the dtype
            xps.append(F.linear(x.to(dt), w_i.to(dt)) + b_i.to(dt))
            whs.append(cell.hidden_weight().to(dt))
            bns.append(cell.hn.bias.to(dt))
        bn = torch.stack(bns)[:, None, :]                   # [2, 1, H]

        def step(h, xk, w_h):
            gh = torch.bmm(h.to(dt), w_h.transpose(1, 2))   # [2, B, 3H]
            rz = torch.sigmoid(xk[..., :2 * hidden] + gh[..., :2 * hidden])
            r, z = rz[..., :hidden], rz[..., hidden:]
            n = torch.tanh(xk[..., 2 * hidden:]
                           + r * (gh[..., 2 * hidden:] + bn))
            return (1.0 - z) * n + z.float() * h

        fwd, bwd = _run_gru_pair(torch.stack(xps), torch.stack(whs), step,
                                 time_aligned=True,
                                 carry_dtype=torch.float32)
        return fwd + bwd

    def _keras_layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The ``keras_parity`` GRU layer i (f32): the forward outputs plus
        the ``go_backwards`` ones in processing order."""
        hidden = self.config.hidden
        grus = (getattr(self, f"gru_fwd_{i}"), getattr(self, f"gru_bwd_{i}"))
        xp = torch.stack([F.linear(x, g.weight) + g.bias for g in grus])
        w_h = torch.stack([g.recurrent_weight for g in grus])  # [2, 3H, H]

        def step(h, xk, w_h):
            rz = torch.bmm(h, w_h[:, :2 * hidden].transpose(1, 2))
            z = hard_sigmoid(xk[..., :hidden] + rz[..., :hidden])
            r = hard_sigmoid(xk[..., hidden:2 * hidden] + rz[..., hidden:])
            hh = torch.tanh(xk[..., 2 * hidden:] + torch.bmm(
                r * h, w_h[:, 2 * hidden:].transpose(1, 2)))
            return z * h + (1.0 - z) * hh

        fwd, bwd = _run_gru_pair(xp, w_h, step, time_aligned=False,
                                 carry_dtype=torch.float32)
        return fwd + bwd

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, 1, T, F] or [B, T, F] -> logits [B, T, vocab] float32.
        ``generator`` draws the dropout masks in training."""
        c = self.config
        if x.dim() == 4:
            x = x[:, 0]
        drop = lambda y: self.dropout(y, generator)       # noqa: E731
        if c.keras_parity:
            x = x.float()
            x = F.relu(self.Dense_0(drop(x)))
            x = F.relu(self.Dense_1(drop(x)))
            for i in range(c.num_layers):
                x = self._keras_layer(drop(x), i)
            x = F.relu(self.Dense_2(drop(x)))
            return self.Dense_3(drop(x))
        x = x.to(c.dtype)
        x = drop(F.relu(self.Dense_0(x)))
        x = drop(F.relu(self.Dense_1(x)))
        for i in range(c.num_layers):
            x = drop(self._layer(x, i))
        x = F.relu(self.Dense_2(x))
        return self.Dense_3(x)
