"""Mixed-precision policy: parameter, compute and output dtypes.

Port of ripor_tpu/core/precision.py with torch dtypes. The reference flips
HF's ``bf16`` flag (t5_pretrainer/main.py:152); here the policy is an
explicit object. ``DEFAULT_POLICY`` computes in bf16 with f32 parameters
and outputs; ``FP32_POLICY`` computes in f32, as the trainer does
(``TrainConfig.bf16_compute`` is read by neither package).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x).to(self.compute_dtype)

    def cast_to_output(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x).to(self.output_dtype)


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
