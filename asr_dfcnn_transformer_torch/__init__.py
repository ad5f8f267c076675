"""PyTorch / CUDA port of ``asr_dfcnn_transformer_tpu`` for NVIDIA Hopper.

The batched AM -> LM recognition path (``infer/``): device-side fbank,
SE-DFCNN acoustic model, greedy CTC decode, Transformer LM, and the
micro-batching server in front of them; and the training of both models
(``train/``: CTC and label-smoothed LM losses, Adam, checkpoints). The JAX
package's Pallas kernels on those paths are hand-written CUDA C++ here
(``csrc/``, bound through ``kernels/``), each with a plain-PyTorch twin
that CPU tensors run.

Imports ``torch`` and never ``jax``; of the JAX package it reuses only the
JAX-free ``core`` (constants and vocabularies), re-exported below.
"""

__version__ = "0.1.0"

from asr_dfcnn_transformer_tpu.core import constants, vocab  # noqa: F401
