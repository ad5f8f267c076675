"""AM -> LM pipeline and the micro-batching server."""

from asr_dfcnn_transformer_torch.infer.pipeline import (  # noqa: F401
    Pipeline,
    infer_bucket_frames,
    pipeline_program,
)
from asr_dfcnn_transformer_torch.infer.serving import (  # noqa: F401
    BatchingServer,
    ServerStats,
)
