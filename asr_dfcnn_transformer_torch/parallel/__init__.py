"""Data and tensor parallelism over ``torch.distributed``: the port of the
JAX package's ``parallel`` (``mesh.py``), one process per device."""

from asr_dfcnn_transformer_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    backend_for,
    destroy,
    init_distributed,
    make_mesh,
    param_shardings,
    shard_batch,
)
