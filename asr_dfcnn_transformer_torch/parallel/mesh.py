"""Process mesh and sharding rules: the port of ``parallel/mesh.py``.

JAX drives every local device from one process and lays a ``(data,
model)`` mesh over ``jax.devices()``. PyTorch's idiom is one process per
device, so here a mesh is a ``(data, model)`` grid of processes, each on
one device, over the initialised ``torch.distributed`` world (ranks in
row-major order, as ``make_mesh`` reshapes the devices), and a single
process is a mesh of one:

- batches are sharded on ``data``: every process loads the same global
  batch and :func:`shard_batch` carves out its rows;
- the LM is optionally tensor-parallel on ``model`` (``parallel/tensor.py``)
  by :func:`param_shardings`' Megatron rules: attention-head and FFN-inner
  dimensions split by columns, the second projections by rows, embeddings
  on their features, the vocabulary projection on the vocabulary;
- under ``pjit`` XLA inserts the gradient psum and every reduction of a
  global loss; here the trainers insert each one by hand.

The backend is NCCL for CUDA and gloo for the CPU unless the caller names
one (two ranks on one card need gloo: NCCL refuses two ranks of one
communicator on one device).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from asr_dfcnn_transformer_torch.convert import flax_leaf


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of processes. ``shape`` maps the axis names
    to their sizes; ``data_group`` / ``model_group`` are the process groups
    along each axis (None where the axis has size 1), ``data_rank`` /
    ``model_rank`` this process's place on them."""

    shape: Dict[str, int]
    device: torch.device
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    data_rank: int = 0
    model_rank: int = 0

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def is_writer(self) -> bool:
        """True on the one process that writes checkpoints, stamps, metrics
        and traces (global rank 0)."""
        return self.data_rank == 0 and self.model_rank == 0

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()


def backend_for(device, world_size: int = 1) -> str:
    """NCCL when ``device`` is a card and each of the ``world_size`` ranks
    can have a card of its own; gloo on the CPU, and for more ranks than
    cards (NCCL refuses two ranks on one card)."""
    if (torch.device(device).type == "cuda"
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: float = 600.0) -> torch.device:
    """Join the process group and return this process's device.

    ``init_method`` is a ``file://`` or ``tcp://`` address; without one
    the group comes from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). ``device`` defaults
    to ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` unset: the rank modulo the
    card count). The backend is :func:`backend_for` the device and the
    world; it is printed and never switched on failure. Every collective
    waits at most ``timeout`` seconds."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the process group on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device, world_size)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    print(f"[distributed] backend {backend}, rank {rank} of {world_size} "
          f"on {device}", flush=True)
    return device


def make_mesh(data_parallel: int = -1, model_parallel: int = 1,
              device=None) -> Mesh:
    """A (data, model) mesh over the process group (a mesh of one without
    one). ``data_parallel=-1`` takes every remaining process; the grid
    must cover the world. ``device`` is this process's (default: the
    current CUDA device). Every process of the group makes the same calls
    in the same order: each mesh creates its process groups
    collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data_parallel == -1:
        if world % model_parallel:
            raise ValueError(f"model_parallel {model_parallel} does not "
                             f"divide the {world} processes")
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"a ({data_parallel}, {model_parallel}) mesh needs "
                         f"{data_parallel * model_parallel} processes; the "
                         f"process group has {world}")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    shape = {"data": data_parallel, "model": model_parallel}
    if world == 1:
        return Mesh(shape, device)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, (data_parallel, model_parallel),
                          mesh_dim_names=("data", "model"))
    return Mesh(shape, device,
                data_group=dm.get_group("data") if data_parallel > 1 else None,
                model_group=(dm.get_group("model") if model_parallel > 1
                             else None),
                data_rank=dm.get_local_rank("data"),
                model_rank=dm.get_local_rank("model"))


def shard_batch(mesh: Mesh, batch):
    """This process's rows of a global batch: ``batch`` (an array, numpy or
    torch) or every array of it (a tuple, a list or a dataclass such as
    ``AMBatch``) is cut
    along its leading axis into ``mesh.shape["data"]`` equal parts and the
    ``data_rank``-th is kept; other fields (``bucket_frames``) stay. Every
    process of the run feeds the same global batch, which the loaders make
    deterministically from the seed."""
    n = mesh.shape["data"]

    def cut(x):
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"global batch {x.shape[0]} must divide "
                             f"process count {n}")
        per = x.shape[0] // n
        return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]

    if n == 1:
        return batch
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        return cut(batch)
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: cut(getattr(batch, f.name))
            for f in dataclasses.fields(batch)})
    return type(batch)([cut(x) for x in batch])


# Megatron-style tensor-parallel rules, on the Flax path of each parameter
# (convert.flax_leaf): column-parallel QKV projections and FFN inner
# (shard output features); row-parallel attention out / FFN second matmul
# (shard input features); embeddings on features, the vocabulary
# projection on the vocabulary.
_COL_RE = re.compile(r"(attn.*/(q|k|v)/kernel|ffn/Dense_0/kernel)")
_ROW_RE = re.compile(r"(attn.*/out/kernel|ffn/Dense_1/kernel)")
_EMBED_RE = re.compile(r"(embed.*/embedding|output/kernel)")

Params = Union[Dict[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]]


def param_shardings(mesh: Mesh, named_parameters: Params,
                    tensor_parallel: bool = False
                    ) -> Dict[str, Optional[int]]:
    """{parameter name: the axis of the port's tensor split over ``model``,
    or None for replicated}, by the JAX rules on each parameter's Flax path
    and its ``fits`` test (a split axis must divide by the ``model`` size;
    one that does not stays replicated). With ``tensor_parallel`` off,
    with a ``model`` axis of 1, and for 1-D parameters, everything is
    replicated."""
    model_size = mesh.shape["model"]
    items = (named_parameters.items() if isinstance(named_parameters, dict)
             else named_parameters)
    out: Dict[str, Optional[int]] = {}
    for name, leaf in items:
        out[name] = None
        if not tensor_parallel or model_size == 1 or leaf.ndim < 2:
            continue
        _, path, axes = flax_leaf(name, leaf.ndim)

        def fits(flax_axis):
            return leaf.shape[axes[flax_axis]] % model_size == 0

        if _COL_RE.search(path) and fits(-1):
            out[name] = axes[-1]
        elif _ROW_RE.search(path) and fits(0):
            out[name] = axes[0]
        elif _EMBED_RE.search(path) and fits(-1):
            out[name] = axes[-1]
    return out


def destroy() -> None:
    """Leave the process group, when there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
