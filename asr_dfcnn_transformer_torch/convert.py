"""Weight bridge between the JAX package's Flax variables and the port's
state_dicts, both ways, and a JAX checkpoint into a port checkpoint.

Input is the variables as nested dicts of numpy arrays, i.e.
``{"params": ..., "batch_stats": ...}`` after ``jax.tree.map(np.asarray,
variables)``; this module itself needs no JAX. The port's modules carry the
Flax tree's names, so a path maps onto a state_dict key one to one; only
the leaves change:

- conv ``kernel`` HWIO [kh, kw, in, out] -> ``weight`` OIHW;
- dense ``kernel`` [in, out] -> ``weight`` [out, in] (also the Keras GRU's
  fused ``kernel`` [F, 3H]), and the Keras GRU's ``recurrent_kernel``
  [H, 3H] -> ``recurrent_weight`` [3H, H];
- BatchNorm / LayerNorm ``scale`` -> ``weight``; batch_stats ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``;
- ``bias`` and ``embedding`` as they are.

The epsilons (BatchNorm 1e-3, Flax LayerNorm 1e-6) live in the port's
modules, not in the weights. :func:`state_dict_to_flax` is the exact
inverse (the TF1 exporters of ``infer/tf_ckpt.py`` take its output), and
:func:`flax_checkpoint_to_port` writes a JAX checkpoint's raw tree as a
port checkpoint directory.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaf(name: str, value: np.ndarray) -> tuple:
    a = np.array(value, dtype=np.float32)    # a writable copy
    if name == "kernel":
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return "weight", a.T
        raise ValueError(f"unexpected kernel rank {a.ndim}")
    if name == "recurrent_kernel":
        return "recurrent_weight", a.T
    if name == "scale":
        return "weight", a
    if name in ("bias", "embedding"):
        return name, a
    raise ValueError(f"unknown Flax parameter name {name!r}")


def _walk(tree: Mapping[str, Any], prefix: str, collection: str,
          out: Dict[str, torch.Tensor]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{key}.", collection, out)
            continue
        if collection == "batch_stats":
            name, arr = _STAT_NAMES[key], np.array(value, np.float32)
        else:
            name, arr = _leaf(key, value)
        out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))


def flax_to_state_dict(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Any of the port's models: Flax variables -> torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        if collection in variables:
            _walk(variables[collection], "", collection, out)
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    return out


def am_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """AM variables (params + batch_stats) of ``SEDFCNN``, ``DFCNN`` or
    ``KerasDFCNN`` (``infer/hdf5_import.py``'s loader gives the last) ->
    the port's model's state_dict (load with ``strict=True``)."""
    if "batch_stats" not in variables:
        raise ValueError("AM variables need batch_stats")
    return flax_to_state_dict(variables)


def lm_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``TransformerLM`` variables (params) -> the port's ``TransformerLM``
    state_dict (load with ``strict=True``)."""
    return flax_to_state_dict(variables)


def e2e_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``SpeechTransformer`` variables (params + the pre-net's batch_stats)
    -> the port's ``SpeechTransformer`` state_dict (load with
    ``strict=True``)."""
    if "batch_stats" not in variables:
        raise ValueError("e2e variables need the pre-net's batch_stats")
    return flax_to_state_dict(variables)


def bigru_state_dict(variables: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """``BiGRUCTC`` variables (params only), either recurrence: the Flax
    ``GRUCell_{i}`` Dense layers (``ir`` / ``iz`` / ``in`` / ``hr`` /
    ``hz`` / ``hn``) of the default path, or the Keras ``gru_{fwd,bwd}_{i}``
    ``kernel`` / ``recurrent_kernel`` / ``bias`` of ``keras_parity`` (what
    ``infer/hdf5_import.load_keras_bigru_hdf5`` gives) -> the port's
    ``BiGRUCTC`` state_dict (load with ``strict=True``)."""
    if "batch_stats" in variables:
        raise ValueError("BiGRU variables hold no batch statistics")
    return flax_to_state_dict(variables)


def atten_state_dict(variables: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """``CTCAttention`` variables (params + the conv cells' batch_stats)
    -> the port's ``CTCAttention`` state_dict (load with ``strict=True``)."""
    if "batch_stats" not in variables:
        raise ValueError("CTC-attention variables need batch_stats")
    return flax_to_state_dict(variables)


def joint_state_dict(variables: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
    """``AMLMJoint`` variables (``am`` / ``lm`` params + the AM's
    batch_stats) -> the port's ``AMLMJoint`` state_dict (load with
    ``strict=True``)."""
    if "batch_stats" not in variables:
        raise ValueError("joint variables need the AM's batch_stats")
    return flax_to_state_dict(variables)


_KINDS = ("am", "lm", "e2e", "bigru", "atten", "joint")
_NO_STATS = ("lm", "bigru")
_FLAX_STATS = {v: k for k, v in _STAT_NAMES.items()}


def state_dict_to_flax(sd: Mapping[str, torch.Tensor], kind: str
                       ) -> Dict[str, Any]:
    """The exact inverse of :func:`flax_to_state_dict` for a model of
    ``kind`` ("am", "lm", "e2e", "bigru", "atten" or "joint"): f32 numpy
    leaves, OIHW conv weights back to HWIO ``kernel``, [out, in] dense
    weights to [in, out], ``recurrent_weight`` to ``recurrent_kernel``,
    1-D ``weight`` to ``scale``, ``running_mean`` / ``running_var`` to
    batch_stats ``mean`` / ``var``."""
    if kind not in _KINDS:
        raise ValueError(f"kind={kind!r}: expected one of {_KINDS}")
    out: Dict[str, Any] = {"params": {}}
    for key, value in sd.items():
        *path, name = key.split(".")
        a = value.detach().cpu().to(torch.float32).numpy()
        if name in _FLAX_STATS:
            collection, leaf = "batch_stats", _FLAX_STATS[name]
        elif name == "weight":
            collection, leaf = "params", {4: "kernel", 2: "kernel",
                                          1: "scale"}[a.ndim]
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else \
                a.T if a.ndim == 2 else a
        elif name == "recurrent_weight":
            collection, leaf, a = "params", "recurrent_kernel", a.T
        elif name in ("bias", "embedding"):
            collection, leaf = "params", name
        else:
            raise ValueError(f"unknown state_dict entry {key!r}")
        node = out.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    if kind in _NO_STATS and "batch_stats" in out:
        raise ValueError(f"{kind} state_dicts hold no batch statistics")
    if kind not in _NO_STATS and "batch_stats" not in out:
        raise ValueError(f"{kind} state_dicts need batch statistics")
    return out


def _numpy_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    return {k: _numpy_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def flax_checkpoint_to_port(raw_tree: Mapping[str, Any],
                            stamp: Optional[Mapping[str, Any]],
                            ckpt_dir: str) -> None:
    """Write a JAX checkpoint as a port checkpoint directory.

    ``raw_tree``: the JAX ``CheckpointManager(dir).restore_raw_best()`` (or
    ``restore_raw_latest()``) tree, nested mappings of array-likes with
    ``params`` and (AM, e2e) ``batch_stats``; its optimizer state is
    dropped. ``stamp``: the JAX directory's ``identity.json`` as read
    (``train.identity.read_identity``), or None. Writes ``0.pt`` holding
    ``{"model": state_dict, "step": 0}``, the same state as
    ``best/state.pt``, and the stamp unchanged, under ``ckpt_dir``; a port
    trainer restores the model from it with a fresh optimizer at step 0,
    ``Pipeline.from_checkpoints`` serves it."""
    from asr_dfcnn_transformer_torch.train import identity
    from asr_dfcnn_transformer_torch.train.checkpoint import CheckpointManager
    variables = {c: _numpy_tree(raw_tree[c])
                 for c in ("params", "batch_stats") if raw_tree.get(c)}
    state = {"model": flax_to_state_dict(variables), "step": 0}
    mgr = CheckpointManager(ckpt_dir)
    mgr.save(0, state)
    mgr.save_best(state)
    if stamp is not None:
        identity.write_stamp(os.path.abspath(ckpt_dir), dict(stamp))
