from ripor_tpu_torch.core.precision import DEFAULT_POLICY, FP32_POLICY, Policy

__all__ = ["Policy", "DEFAULT_POLICY", "FP32_POLICY"]
