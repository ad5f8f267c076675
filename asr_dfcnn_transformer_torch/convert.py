"""Weight bridge: the JAX package's Flax variables -> the port's state_dicts.

Input is the variables as nested dicts of numpy arrays, i.e.
``{"params": ..., "batch_stats": ...}`` after ``jax.tree.map(np.asarray,
variables)``; this module itself needs no JAX. The port's modules carry the
Flax tree's names, so a path maps onto a state_dict key one to one; only
the leaves change:

- conv ``kernel`` HWIO [kh, kw, in, out] -> ``weight`` OIHW;
- dense ``kernel`` [in, out] -> ``weight`` [out, in];
- BatchNorm / LayerNorm ``scale`` -> ``weight``; batch_stats ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``;
- ``bias`` and ``embedding`` as they are.

The epsilons (BatchNorm 1e-3, Flax LayerNorm 1e-6) live in the port's
modules, not in the weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
    """``SEDFCNN`` variables (params + batch_stats) -> the port's
    ``SEDFCNN`` state_dict (load with ``strict=True``)."""
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
