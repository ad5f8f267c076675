"""Trainers for the AM, the LM, CTC-attention, the joint AM -> LM and the
e2e speech Transformer, with their schedule and checkpoints."""

from asr_dfcnn_transformer_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
)
from asr_dfcnn_transformer_torch.train.schedule import (  # noqa: F401
    polynomial_decay_with_cycle,
)
from asr_dfcnn_transformer_torch.train.trainer import (  # noqa: F401
    AMTrainer,
    AttenTrainer,
    E2ETrainer,
    JointTrainer,
    LMTrainer,
    MetricWriter,
)
