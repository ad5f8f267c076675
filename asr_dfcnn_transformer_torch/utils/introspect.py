"""Model introspection: the port of ``utils/introspect.py``.

:func:`attention_maps` recovers every attention probability tensor of a
forward pass (the reference wrote the first head's scores to TensorBoard,
``end2end/transformer.py:105-106``), for any model built from
``models.layers.MultiHeadAttention``: the LM, CTC-attention and the speech
Transformer.
"""

from __future__ import annotations

from typing import Dict

import torch

from asr_dfcnn_transformer_torch.models.layers import capture_attention


@torch.no_grad()
def attention_maps(model: torch.nn.Module, *args,
                   **kwargs) -> Dict[str, torch.Tensor]:
    """Run ``model(*args, **kwargs)`` in its current mode, capturing the
    attention probabilities. Returns {Flax module path: [B, H, Tq, Tk]
    probabilities}, the keys the JAX function gives."""
    with capture_attention(model) as maps:
        model(*args, **kwargs)
    return dict(maps)
