from ripor_tpu_torch.quantize.kmeans import (assign_codes, kmeans_fit,
                                             kmeans_fit_batched)
from ripor_tpu_torch.quantize.rq import (
    RQCodebooks,
    reconstruction_mse,
    rq_decode,
    rq_encode,
    train_rq,
)

__all__ = [
    "assign_codes", "kmeans_fit", "kmeans_fit_batched",
    "RQCodebooks", "train_rq", "rq_encode", "rq_decode", "reconstruction_mse",
]
