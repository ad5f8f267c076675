"""Megatron tensor parallelism of a model over a mesh's ``model`` axis.

:func:`shard_model` keeps, on each rank, the shards of the parameters that
``param_shardings(mesh, ..., tensor_parallel=True)`` splits, and gives each
cut module its :class:`~asr_dfcnn_transformer_torch.models.layers.Split`:
q / k / v and the FFN's ``Dense_0`` by columns (each rank runs its heads
and inner columns), attention ``out`` and ``Dense_1`` by rows (the partial
products are summed, then the bias is added once), the embeddings on their
features and the vocabulary projection on the vocabulary (both
all-gathered). JAX's rules leave a parameter whose split axis does not
divide replicated; a module with a split the port has no form for raises
(an attention whose heads do not divide, a lone split of a pair).

A checkpoint holds the whole model: :func:`full_state` gathers the shards
(and those of Adam's moments) and :func:`local_state` cuts a whole state to
this rank's, so checkpoints, identity stamps and the ``convert.py`` bridges
are those of a single process.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from asr_dfcnn_transformer_torch.models.layers import (Dense, FeedForward,
                                                       LearnedPositionEmbed,
                                                       MultiHeadAttention,
                                                       ScaledEmbed, Split)
from asr_dfcnn_transformer_torch.parallel.mesh import Mesh, param_shardings

Specs = Dict[str, Optional[int]]


def shard_model(model: nn.Module, mesh: Mesh) -> Specs:
    """Cut ``model`` in place to this rank's shards; returns the specs
    ({parameter name: split axis or None}). A ``model`` axis of 1 leaves the
    model whole."""
    specs = param_shardings(mesh, model.named_parameters(),
                            tensor_parallel=True)
    if mesh.shape["model"] == 1:
        return specs
    split = Split(mesh.model_group, mesh.model_rank, mesh.shape["model"])

    def cut(prefix: str, kind: str, axis: int):
        if specs.get(prefix + "weight") != axis:
            raise ValueError(f"{prefix}weight: a {kind} split needs axis "
                             f"{axis}, the rules give "
                             f"{specs.get(prefix + 'weight')}")
        return Split(split.group, split.rank, split.size, kind)

    claimed = set()
    for name, mod in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(mod, MultiHeadAttention) and specs[pre + "q.weight"] \
                is not None:
            if mod.num_heads % split.size:
                raise ValueError(f"{name}: {mod.num_heads} heads do not "
                                 f"divide over {split.size} ranks")
            for p in ("q", "k", "v"):
                getattr(mod, p).split = cut(f"{pre}{p}.", "column", 0)
            mod.out.split = cut(pre + "out.", "row", 1)
            mod.split = split
            claimed |= {f"{pre}{p}.weight" for p in ("q", "k", "v", "out")}
        elif isinstance(mod, (ScaledEmbed, LearnedPositionEmbed)) and \
                specs[pre + "embedding"] is not None:
            mod.split = split
            claimed.add(pre + "embedding")
        elif isinstance(mod, FeedForward) and \
                specs[pre + "Dense_0.weight"] is not None:
            mod.Dense_0.split = cut(pre + "Dense_0.", "column", 0)
            mod.Dense_1.split = cut(pre + "Dense_1.", "row", 1)
            claimed |= {pre + "Dense_0.weight", pre + "Dense_1.weight"}
        elif isinstance(mod, Dense) and name == "output" and \
                specs[pre + "weight"] is not None:
            mod.split = cut(pre, "vocab", 0)
            claimed.add(pre + "weight")
    unclaimed = {n for n, a in specs.items() if a is not None} - claimed
    if unclaimed:
        raise ValueError(f"no tensor-parallel form for {sorted(unclaimed)}")
    params = dict(model.named_parameters())
    for name, axis in specs.items():
        if axis is not None:
            p = params[name]
            p.data = split.local(p.data, axis).contiguous()
    return specs


def _gather(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=axis)


def _cut(t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    return t.chunk(mesh.shape["model"], axis)[mesh.model_rank].contiguous()


def _moments(opt_state: dict, specs: Specs, fn) -> dict:
    """Adam's state with ``fn(tensor, axis)`` applied to the moments of
    every split parameter (the optimizer keys parameters by their index in
    ``model.parameters()``, the order of ``specs``)."""
    axes = list(specs.values())
    state = {}
    for idx, s in opt_state["state"].items():
        axis = axes[int(idx)]
        state[idx] = {k: (fn(v, axis) if axis is not None and
                          isinstance(v, torch.Tensor) and v.dim() > 0 else v)
                      for k, v in s.items()}
    return {**opt_state, "state": state}


def full_state(model_sd: dict, opt_sd: dict, specs: Specs, mesh: Mesh):
    """(model state, optimizer state) with every shard all-gathered: the
    state of the whole model, on every rank of the ``model`` group."""
    model_sd = {k: (_gather(v, specs[k], mesh) if specs.get(k) is not None
                    else v) for k, v in model_sd.items()}
    return model_sd, _moments(opt_sd, specs,
                              lambda t, a: _gather(t, a, mesh))


def local_state(model_sd: dict, opt_sd: Optional[dict], specs: Specs,
                mesh: Mesh):
    """The inverse of :func:`full_state`: a whole state cut to this rank's
    shards."""
    model_sd = {k: (_cut(v, specs[k], mesh) if specs.get(k) is not None
                    else v) for k, v in model_sd.items()}
    if opt_sd is not None:
        opt_sd = _moments(opt_sd, specs, lambda t, a: _cut(t, a, mesh))
    return model_sd, opt_sd
