"""Data layer: batch types, manifests, the bucketing loader, synthetic
fixtures."""

from asr_dfcnn_transformer_torch.data.batches import (  # noqa: F401
    AMBatch,
    LMBatch,
)
from asr_dfcnn_transformer_torch.data.loader import (  # noqa: F401
    DataLoader,
    prefetch,
)
from asr_dfcnn_transformer_torch.data.manifest import (  # noqa: F401
    Manifest,
    generate_hanzi_dict,
    load_manifests,
    read_manifest,
)
from asr_dfcnn_transformer_torch.data.synthetic import (  # noqa: F401
    make_synthetic_corpus,
)
