from ripor_tpu_torch.utils.observability import (
    MetricsLogger,
    StepTimer,
    estimate_train_flops_per_token,
    peak_flops,
    profile_trace,
)

__all__ = ["MetricsLogger", "StepTimer", "estimate_train_flops_per_token",
           "peak_flops", "profile_trace"]
