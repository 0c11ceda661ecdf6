"""Hot ops of the decode paths: each is a hand-written CUDA kernel for
sm_90a (sources in ripor_tpu_torch/csrc/) with its plain PyTorch version
beside it. A wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises. ``KERNEL_LAUNCHES`` counts
kernel launches per kernel body, ``SCHEDULE_LAUNCHES`` K2's launches by
consumer schedule.

  megarow path:            K1 reorder_cache_all, K2 step_attention_seq,
                           K3 beam_gather_rows; its dataflows' bodies
                           K1' (quantize on insert) and K1'' (fused kvg
                           gather) of K1, K2' (mxu_math) of K2
  deferred path:           K4 step_attend_reorder, K3
  non-deferred path:       K5 step_attention_fused, K3, K6 beam_gather_update
  write-then-attend path:  K8 step_attention, K7 beam_gather_blocks

reorder_cache_pallas reorders a sequence or dict of [B, N, ...] tensors
with one K3 launch.
"""
from ripor_tpu_torch.ops._build import KERNEL_LAUNCHES, SCHEDULE_LAUNCHES
from ripor_tpu_torch.ops.attend_reorder import (
    SCALE_COLS,
    quantize_rows_int4_plain,
    quantize_rows_plain,
    step_attend_reorder,
    step_attend_reorder_plain,
)
from ripor_tpu_torch.ops.beam_gather import (
    beam_gather_blocks,
    beam_gather_blocks_plain,
    beam_gather_rows,
    beam_gather_rows_plain,
    beam_gather_update,
    beam_gather_update_plain,
    reorder_cache_pallas,
)
from ripor_tpu_torch.ops.megarow import (
    reorder_cache_all,
    reorder_cache_all_plain,
    step_attention_seq,
    step_attention_seq_plain,
)
from ripor_tpu_torch.ops.step_attention import (
    step_attention,
    step_attention_fused,
    step_attention_fused_plain,
    step_attention_plain,
)

__all__ = [
    "KERNEL_LAUNCHES", "SCHEDULE_LAUNCHES", "SCALE_COLS",
    "quantize_rows_plain", "quantize_rows_int4_plain", "beam_gather_rows",
    "beam_gather_rows_plain",
    "beam_gather_update", "beam_gather_update_plain", "reorder_cache_all",
    "reorder_cache_all_plain", "step_attention_seq",
    "step_attention_seq_plain", "step_attend_reorder",
    "step_attend_reorder_plain", "step_attention_fused",
    "step_attention_fused_plain", "step_attention", "step_attention_plain",
    "beam_gather_blocks", "beam_gather_blocks_plain", "reorder_cache_pallas",
]
