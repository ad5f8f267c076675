"""PyTorch / CUDA port of ``asr_dfcnn_transformer_tpu`` for NVIDIA Hopper.

The batched AM -> LM recognition path (``infer/``): device-side fbank,
SE-DFCNN acoustic model, greedy or prefix-beam CTC decode, Transformer LM,
and the micro-batching server in front of them; and the training of both
models (``train/``: CTC and label-smoothed LM losses, Adam, checkpoints).
The JAX package's Pallas kernels on those paths are hand-written CUDA C++
here (``csrc/``, bound through ``kernels/``), each with a plain-PyTorch
twin that CPU tensors run. Models build on ``cuda`` unless given a device.

Imports ``torch`` and nothing of ``jax`` or of the JAX package: constants
and vocabularies are the port's own copies (``core/``, ``assets/``),
re-exported below.
"""

__version__ = "0.1.0"

from asr_dfcnn_transformer_torch.core import constants, vocab  # noqa: F401
