"""Seeded float32 weights for one model, drawn on the device in one call.

One ``torch.randn`` of every element of the model, from a generator on
the device seeded from the run's seed, then each named tensor is its slice,
shaped by its kind: convolution and dense kernels He-scaled (sqrt(2 /
fan_in), the unit normal clipped at 2) so that activations keep their
scale through the ReLU stacks; biases 0.02 z; BatchNorm and LayerNorm scales
1 + 0.1 z and shifts 0.1 z; BatchNorm running statistics those of a ReLU's
output where one precedes it (means 1 / sqrt(pi) + 0.05 z, variances
(1 - 1 / pi) (1 + 0.1 |z|)), else means 0.1 z and variances 1 + 0.1 |z|;
token embeddings z / sqrt(d); positions 0.02 z. The same dict
loads into the port's model and feeds the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.models import Spec, param_spec
from portbench.traffic import derive


# mean and variance of relu(y), y ~ N(0, 2): a He-scaled convolution of
# unit-variance input; a BatchNorm after a ReLU holds them as its running
# statistics, so that its output is about N(0, 1), as in a trained network
RELU_MEAN = 1.0 / math.sqrt(math.pi)
RELU_VAR = 1.0 - 1.0 / math.pi


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(total, generator=g, device=dev)
    out, off = {}, 0
    for name, shape, kind, fan_in in spec:
        n = math.prod(shape)
        x = z[off:off + n].view(shape)
        off += n
        if kind in ("conv", "dense"):
            x = x.clamp(-2.0, 2.0) * math.sqrt(2.0 / fan_in)
        elif kind == "bias":
            x = 0.02 * x
        elif kind in ("bn_weight", "ln_weight"):
            x = 1.0 + 0.1 * x
        elif kind in ("bn_bias", "ln_bias", "bn_mean"):
            x = 0.1 * x
        elif kind == "bn_var":
            x = 1.0 + 0.1 * x.abs()
        elif kind == "bn_mean_relu":
            x = RELU_MEAN + 0.05 * x
        elif kind == "bn_var_relu":
            x = RELU_VAR * (1.0 + 0.1 * x.abs())
        elif kind == "embed":
            x = x / math.sqrt(fan_in)
        elif kind == "pos":
            x = 0.02 * x
        else:
            raise ValueError(f"unknown tensor kind {kind!r} of {name}")
        out[name] = x.contiguous()
    return out


def for_model(cfg: dict, part: str, seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """The weights of the configuration's ``part`` ("am" or "lm") for the
    run's seed."""
    kind = cfg["am"]["family"] if part == "am" else "lm"
    return make(param_spec(kind, cfg[part]), derive(seed, part), device)
