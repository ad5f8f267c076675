"""Audio front end (log-filterbank + CMVN, colored-noise augmentation,
SpecAugment, low-frame-rate stacking) and wav IO."""

from asr_dfcnn_transformer_torch.audio.fbank import (  # noqa: F401
    FbankConfig,
    batched_fbank,
    num_frames,
)
from asr_dfcnn_transformer_torch.audio.lfr import (  # noqa: F401
    batched_lfr,
    build_lfr_features,
    lfr_length,
)
from asr_dfcnn_transformer_torch.audio.noise import (  # noqa: F401
    add_noise_batch,
    color_noise,
    snr_to_gain,
)
from asr_dfcnn_transformer_torch.audio.specaugment import (  # noqa: F401
    SpecAugmentConfig,
    spec_augment,
)
