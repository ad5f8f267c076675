"""Audio front end (log-filterbank + CMVN)."""

from asr_dfcnn_transformer_torch.audio.fbank import (  # noqa: F401
    FbankConfig,
    batched_fbank,
    num_frames,
)
