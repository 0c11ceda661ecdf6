from ripor_tpu_torch.serve.engine import (
    BaseEngine,
    RetrievalEngine,
    ServeConfig,
)
from ripor_tpu_torch.serve.http import serve_http

__all__ = ["BaseEngine", "RetrievalEngine", "ServeConfig", "serve_http"]
