"""Acoustic model and language model."""

from asr_dfcnn_transformer_torch.models.dfcnn import (  # noqa: F401
    SEDFCNN,
    SEDFCNNConfig,
    frames_from_samples,
    logit_lengths,
)
from asr_dfcnn_transformer_torch.models.transformer_lm import (  # noqa: F401
    TransformerLM,
    TransformerLMConfig,
)
