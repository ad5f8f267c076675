"""AM -> LM pipeline, the micro-batching server, and e2e serving."""

from asr_dfcnn_transformer_torch.infer.e2e_serving import (  # noqa: F401
    E2EServing,
    e2e_program,
)
from asr_dfcnn_transformer_torch.infer.pipeline import (  # noqa: F401
    EvalResult,
    Pipeline,
    infer_bucket_frames,
    pipeline_program,
)
from asr_dfcnn_transformer_torch.infer.serving import (  # noqa: F401
    BatchingServer,
    ServerStats,
)
