from ripor_tpu_torch.serve.engine import (
    BaseEngine,
    DenseEngine,
    RetrievalEngine,
    ServeConfig,
)
from ripor_tpu_torch.serve.http import serve_http

__all__ = ["BaseEngine", "DenseEngine", "RetrievalEngine", "ServeConfig",
           "serve_http"]
