"""Decoders."""

from asr_dfcnn_transformer_torch.ops.ctc_decode import (  # noqa: F401
    ctc_greedy_decode,
)
