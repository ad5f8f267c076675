"""Hand-written CUDA kernels (sources in ``csrc/``) and their twins.

``LAUNCHES`` counts each kernel's launches since ``reset_launches()``.
"""

from asr_dfcnn_transformer_torch.kernels._build import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from asr_dfcnn_transformer_torch.kernels.attention import (  # noqa: F401
    masked_attention,
    masked_attention_reference,
)
from asr_dfcnn_transformer_torch.kernels.fbank import (  # noqa: F401
    cmvn,
    cmvn_reference,
    log_mel,
    log_mel_reference,
)
