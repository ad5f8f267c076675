"""CTC loss, decoders, edit distance and the matmul inverse FFT."""

from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss  # noqa: F401
from asr_dfcnn_transformer_torch.ops.ctc_decode import (  # noqa: F401
    ctc_beam_search_decode,
    ctc_beam_search_stream_best,
    ctc_beam_search_stream_init,
    ctc_beam_search_stream_step,
    ctc_greedy_decode,
)
from asr_dfcnn_transformer_torch.ops.edit_distance import (  # noqa: F401
    batched_edit_distance,
    edit_distance,
)
from asr_dfcnn_transformer_torch.ops.matfft import (  # noqa: F401
    ifft_matmul,
    irfft_matmul,
)
