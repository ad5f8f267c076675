"""Batch types of the training path."""

from asr_dfcnn_transformer_torch.data.batches import (  # noqa: F401
    AMBatch,
    LMBatch,
)
