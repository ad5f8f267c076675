"""Acoustic models, language model, end-to-end speech Transformer,
CTC-attention and the joint AM -> LM."""

from asr_dfcnn_transformer_torch.models.dfcnn import (  # noqa: F401
    DFCNN,
    SEDFCNN,
    DFCNNConfig,
    KerasDFCNN,
    KerasDFCNNConfig,
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
from asr_dfcnn_transformer_torch.models.bigru import (  # noqa: F401
    BiGRUCTC,
    BiGRUCTCConfig,
    KerasGRU,
)
from asr_dfcnn_transformer_torch.models.ctc_attention import (  # noqa: F401
    CTCAttention,
    CTCAttentionConfig,
)
from asr_dfcnn_transformer_torch.models.am_lm_joint import (  # noqa: F401
    AMLMJoint,
    AMLMJointConfig,
)
