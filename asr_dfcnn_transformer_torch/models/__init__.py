"""Acoustic model, language model and end-to-end speech Transformer."""

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
from asr_dfcnn_transformer_torch.models.speech_transformer import (  # noqa: F401
    SpeechTransformer,
    SpeechTransformerConfig,
    beam_decode,
    beam_decode_cached,
    e2e_loss,
    greedy_decode,
    greedy_decode_cached,
)
