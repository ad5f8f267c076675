"""CTC loss, decoders and edit distance."""

from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss  # noqa: F401
from asr_dfcnn_transformer_torch.ops.ctc_decode import (  # noqa: F401
    ctc_greedy_decode,
)
from asr_dfcnn_transformer_torch.ops.edit_distance import (  # noqa: F401
    batched_edit_distance,
    edit_distance,
)
