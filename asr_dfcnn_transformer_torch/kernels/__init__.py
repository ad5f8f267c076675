"""Hand-written CUDA kernels (sources in ``csrc/``) and their twins.

``LAUNCHES`` counts each kernel's launches since ``reset_launches()``.
``OPS`` names the ``torch.library`` custom ops that hold the forwards
serving runs (an exported program calls them; importing this package
registers them); ``bf16_matmul`` (the bf16 logits head's cuBLAS product)
is an op of the same library but no kernel of the package.
"""

from asr_dfcnn_transformer_torch.kernels._build import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from asr_dfcnn_transformer_torch.kernels.attention import (  # noqa: F401
    MaskedAttention,
    masked_attention,
    masked_attention_bwd_reference,
    masked_attention_reference,
)
from asr_dfcnn_transformer_torch.kernels.beam import (  # noqa: F401
    beam_search,
    beam_search_reference,
)
from asr_dfcnn_transformer_torch.kernels.bf16_matmul import (  # noqa: F401
    bf16_matmul,
)
from asr_dfcnn_transformer_torch.kernels.ctc import (  # noqa: F401
    alpha_stack_reference,
    beta_xi_reference,
    ctc_alpha,
    ctc_beta_xi,
)
from asr_dfcnn_transformer_torch.kernels.dual_attention import (  # noqa: F401
    DualAxisAttention,
    dual_axis_attention,
    dual_axis_attention_bwd_reference,
    dual_axis_attention_reference,
)
from asr_dfcnn_transformer_torch.kernels.fbank import (  # noqa: F401
    cmvn,
    cmvn_reference,
    log_mel,
    log_mel_reference,
)
from asr_dfcnn_transformer_torch.kernels.fft_epilogue import (  # noqa: F401
    interleave_epilogue,
    interleave_epilogue_reference,
)
from asr_dfcnn_transformer_torch.kernels.ffn import (  # noqa: F401
    FusedFFN,
    fused_ffn,
    fused_ffn_bwd_reference,
    fused_ffn_reference,
)
from asr_dfcnn_transformer_torch.kernels.topk import (  # noqa: F401
    topk_last,
    topk_last_reference,
)

#: the custom ops (``torch.ops.asr_port.<name>``), one a kernel forward
OPS = ("log_mel", "cmvn", "masked_attention", "topk_last", "beam_search",
       "dual_axis_attention", "fused_ffn")
