"""Checkpoint model-identity stamps: the port of ``train/identity.py``.

A checkpoint of one architecture can load cleanly into another whose
parameters have the same shapes (an ``se_dfcnn`` checkpoint into an
``se_dfcnn_pre`` model: only ``se_first`` differs) and then silently
compute a different function. Every trainer writes ``identity.json`` next
to its checkpoints, and every restore path compares it with the model:

- STRUCTURAL field mismatches (vocab sizes, depths, head counts, parity
  flags, ...) raise :class:`ModelIdentityError` unless overridden
  (``--force-model-mismatch`` in the CLI).
- ADVISORY fields, performance and numerics knobs that do not change the
  computed function's structure (kernel selection, matmul precision,
  dtype, dropout rate, remat), only warn.

The stamp is the JAX package's, byte for byte, for the same architecture:
``class`` is the Flax module's name (the port's model classes carry it),
``fields`` are the model's config dataclass (``SEDFCNNConfig``,
``DFCNNConfig``, ``KerasDFCNNConfig``, ``BiGRUCTCConfig``,
``TransformerLMConfig``, ``SpeechTransformerConfig``,
``CTCAttentionConfig``, ``AMLMJointConfig``), whose field names
are the Flax module's, and ``torch.float32`` / ``torch.bfloat16`` are
written as JAX writes ``jnp.float32`` / ``jnp.bfloat16``. The port's
``feature_dim`` argument lies outside the config (Flax infers that width
from the first input), so it is not stamped. Either package checks the
other's stamp.

Checkpoints that predate stamping restore without a check and are stamped
on their first restore (a line on stderr says so), so the protection
ratchets on. That first restore is trusted: the stamp then records the
model it was restored into, whatever trained it.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, Optional

import torch

IDENTITY_FILE = "identity.json"

#: Fields whose mismatch does NOT change the computed function's
#: structure: kernel / back-end selection, precision and regularisation
#: knobs. Mismatches warn instead of raising.
ADVISORY_FIELDS = frozenset({
    "dtype", "dropout_rate", "logits_matmul", "remat_stages",
    "fused_attention", "fused_ffn", "prenet_fused", "prenet_conv1_layout",
})

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}


class ModelIdentityError(RuntimeError):
    """A checkpoint's stamped architecture differs structurally from the
    model it is being restored into."""


def _jsonable(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, torch.dtype):
        if v not in _DTYPE_NAMES:
            raise ValueError(f"no stamp name for {v}")
        return f"dtype:{_DTYPE_NAMES[v]}"
    name = getattr(v, "__name__", None)
    if name is not None:
        return f"callable:{name}"
    return f"type:{type(v).__name__}"


def model_identity(model) -> Dict[str, Any]:
    """The architecture stamp of a port model: its class name and every
    field of its ``config`` dataclass, JSON-encoded."""
    cfg = model.config
    fields = {f: _jsonable(getattr(cfg, f))
              for f in cfg.__dataclass_fields__}
    return {"class": type(model).__name__, "fields": fields}


def identity_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, IDENTITY_FILE)


def write_stamp(ckpt_dir: str, stamp: Dict[str, Any]) -> None:
    """Atomically write ``stamp`` as ``ckpt_dir``'s identity file, in the
    JAX package's layout."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = identity_path(ckpt_dir)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(stamp, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def write_identity(ckpt_dir: str, model) -> None:
    """Atomically stamp ``ckpt_dir`` with ``model``'s identity."""
    write_stamp(ckpt_dir, model_identity(model))


def read_identity(ckpt_dir: str) -> Optional[Dict[str, Any]]:
    path = identity_path(ckpt_dir)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def diff_identity(stamped: Dict[str, Any],
                  model) -> Dict[str, Any]:
    """{"structural": {field: (stamped, current)}, "advisory": {...}}
    differences between a stamp and a live model (class name counts as
    structural)."""
    current = model_identity(model)
    structural: Dict[str, Any] = {}
    advisory: Dict[str, Any] = {}
    if stamped.get("class") != current["class"]:
        structural["class"] = (stamped.get("class"), current["class"])
    sf, cf = stamped.get("fields", {}), current["fields"]
    for key in sorted(set(sf) | set(cf)):
        a, b = sf.get(key, "<absent>"), cf.get(key, "<absent>")
        if a != b:
            (advisory if key in ADVISORY_FIELDS else structural)[key] = (a, b)
    return {"structural": structural, "advisory": advisory}


def check_identity(ckpt_dir: str, model, override: bool = False) -> None:
    """Verify ``model`` against the stamp in ``ckpt_dir`` before using its
    checkpoints. Structural mismatch raises :class:`ModelIdentityError`
    (listing every differing field) unless ``override``; advisory
    mismatches, and overridden structural ones, warn on stderr. A missing
    stamp (pre-stamp checkpoint) passes silently."""
    stamped = read_identity(ckpt_dir)
    if stamped is None:
        return
    d = diff_identity(stamped, model)
    if d["advisory"]:
        fields = ", ".join(f"{k}: {a!r} -> {b!r}"
                           for k, (a, b) in d["advisory"].items())
        print(f"# identity: advisory field change vs checkpoint stamp "
              f"({fields})", file=sys.stderr)
    if not d["structural"]:
        return
    fields = "; ".join(f"{k}: checkpoint={a!r}, model={b!r}"
                       for k, (a, b) in d["structural"].items())
    if override:
        print(f"# identity: STRUCTURAL mismatch overridden "
              f"(--force-model-mismatch): {fields}", file=sys.stderr)
        return
    raise ModelIdentityError(
        f"checkpoint under {ckpt_dir!r} was trained with a structurally "
        f"different architecture ({fields}). Restoring would silently "
        f"compute a different function. Rebuild the matching model "
        f"(check <workdir>/config.json and the stamp in "
        f"{identity_path(ckpt_dir)!r}), or pass --force-model-mismatch / "
        f"override=True to proceed anyway.")
