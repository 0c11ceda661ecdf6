from ripor_tpu_torch.models.config import (
    RiporConfig,
    T5Config,
    named_t5,
    ripor_base,
    ripor_small,
    t5_base,
    t5_large,
    t5_small,
)
from ripor_tpu_torch.models.convert import (init_params, params_from_jax,
                                            train_state_from_jax)
from ripor_tpu_torch.models.ripor import RiporModel

__all__ = [
    "RiporConfig", "T5Config", "named_t5", "ripor_base", "ripor_small",
    "t5_base", "t5_large", "t5_small", "RiporModel", "init_params",
    "params_from_jax", "train_state_from_jax",
]
