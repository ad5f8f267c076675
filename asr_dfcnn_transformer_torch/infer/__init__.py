"""AM -> LM pipeline, the micro-batching server, e2e serving, streaming,
serving artifacts and the HTTP front end.

Names are imported on first use, so that loading a serving artifact
(``infer.export_serving``) imports no model code. ``E2EServing`` is the
live e2e server (``infer/e2e_serving.py``); the artifact's e2e class,
``export_serving.E2EServing``, is ``ArtifactE2EServing`` here.
"""

import importlib

_NAMES = {
    "E2EServing": ("e2e_serving", "E2EServing"),
    "e2e_program": ("e2e_serving", "e2e_program"),
    "EvalResult": ("pipeline", "EvalResult"),
    "Pipeline": ("pipeline", "Pipeline"),
    "infer_bucket_frames": ("pipeline", "infer_bucket_frames"),
    "pipeline_program": ("pipeline", "pipeline_program"),
    "BatchingServer": ("serving", "BatchingServer"),
    "ServerStats": ("serving", "ServerStats"),
    "StreamingRecognizer": ("streaming", "StreamingRecognizer"),
    "IncrementalRecognizer": ("streaming", "IncrementalRecognizer"),
    "StreamPool": ("stream_pool", "StreamPool"),
    "StreamSessionManager": ("stream_sessions", "StreamSessionManager"),
    "HTTPRecognitionServer": ("http_server", "HTTPRecognitionServer"),
    "export_pipeline": ("export_serving", "export_pipeline"),
    "export_e2e": ("export_serving", "export_e2e"),
    "load_artifact": ("export_serving", "load_artifact"),
    "ServingPipeline": ("export_serving", "ServingPipeline"),
    "ArtifactE2EServing": ("export_serving", "E2EServing"),
}

__all__ = sorted(_NAMES)


def __getattr__(name):
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _NAMES[name]
    value = getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    globals()[name] = value
    return value
