from ripor_tpu_torch.serve.engine import (
    BaseEngine,
    RetrievalEngine,
    ServeConfig,
)

__all__ = ["BaseEngine", "RetrievalEngine", "ServeConfig"]
