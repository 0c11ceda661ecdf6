"""Hot ops of the megarow decode: each is a hand-written CUDA kernel for
sm_90a (sources in ripor_tpu_torch/csrc/) with its plain PyTorch version
beside it. A wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. ``KERNEL_LAUNCHES`` counts
kernel launches per wrapper."""
from ripor_tpu_torch.ops._build import KERNEL_LAUNCHES
from ripor_tpu_torch.ops.attend_reorder import (
    SCALE_COLS,
    quantize_rows_int4_plain,
    quantize_rows_plain,
)
from ripor_tpu_torch.ops.beam_gather import (
    beam_gather_rows,
    beam_gather_rows_plain,
)
from ripor_tpu_torch.ops.megarow import (
    reorder_cache_all,
    reorder_cache_all_plain,
    step_attention_seq,
    step_attention_seq_plain,
)

__all__ = [
    "KERNEL_LAUNCHES", "SCALE_COLS", "quantize_rows_plain",
    "quantize_rows_int4_plain", "beam_gather_rows", "beam_gather_rows_plain",
    "reorder_cache_all", "reorder_cache_all_plain", "step_attention_seq",
    "step_attention_seq_plain",
]
