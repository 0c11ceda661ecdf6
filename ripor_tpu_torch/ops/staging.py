"""Launch plan of the staged attention kernels, K2 and K4.

Both kernels (csrc/attend_staged.cuh) stage each beam's layer slab of
Mc cache rows, with its q and kv_new rows (and, in K4's in-kernel quantize
mode, kvg's exact row), in a ring of shared-memory stages that persistent
blocks fill with bulk async copies. ``stage_plan`` picks the ring's depth
and the dynamic shared memory that asks for; the wrappers pass both to the
C entries, which recompute the same layout (``make_layout``) and refuse a
launch whose plan differs. A shape whose single stage does not fit raises
ValueError: the kernel does not run, and nothing else runs in its place.

The depth trades against blocks per SM: a block computes one beam at a
time while its other stages load, and more beams computing at once beat a
deeper ring. So the plan keeps the most blocks an SM can hold and, among
equals, the most stages. Measured with chip_stage_bench.py on the H100 at
t5-base, B=8, N=1000 (PERF.md, section 6): int4 rows at Mc=32 run 0.268 ms
(K2) with one stage in three blocks and 0.300 with two in two; int8 0.357
with one stage in two blocks and 0.516 with three in one; bf16 0.333 with
two stages in one block and 0.453 with one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SMEM_LIMIT = 232_448       # dynamic shared memory of one block, H100
SM_SMEM = 233_472          # shared memory of one SM (228 KB)
BLOCK_RESERVED = 1_024     # shared memory the SM reserves per block
MAX_STAGES = 2             # ring depth (at most the kernels' kMaxStages)
BARRIER_SLOTS = 3          # kMaxStages (chip_stage_bench.py tries 3)
# registers: __launch_bounds__(288, 3) holds the instances to 72 a thread
# (ptxas, chip_smoke.py phase 1), so three blocks share an SM's 65,536
MAX_BLOCKS = 3
CONSUMERS = 256            # consumer threads of a block (kConsumers)
SCALE_COLS = 128           # scale tail of a quantized row (row_codec.cuh)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    stages: int
    stage_bytes: int       # one stage: slab, q, kv_new (and kvg's row)
    fixed_bytes: int       # barriers and the per-block scratch
    smem_bytes: int        # fixed_bytes + stages * stage_bytes


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def stage_plan(quant: Optional[str], cache_esz: int, q_esz: int, Mc: int,
               F: int, H: int, exact_kvg: bool = False) -> StagePlan:
    """Stages and shared-memory bytes of one K2 or K4 launch.

    quant: None (exact rows of ``cache_esz`` bytes), "int8" or "int4";
    q_esz: bytes of q's dtype; exact_kvg: K4's in-kernel quantize mode
    (exact kvg rows into a quantized cache), whose kvg row is staged too.
    """
    row_bytes = {None: 2 * F * cache_esz, "int8": 2 * F + SCALE_COLS,
                 "int4": F + SCALE_COLS}[quant]
    stage = (_a16(Mc * row_bytes) + _a16(F * q_esz) + _a16(2 * F * q_esz)
             + (_a16(2 * F * q_esz) if exact_kvg else 0))
    vec = (F // H) % 16 == 0
    cols = 16 if quant is not None else 16 // cache_esz   # per 16-byte chunk
    ncv = F // cols
    groups = (1 if ncv >= CONSUMERS else CONSUMERS // ncv) if vec else 0
    fixed = (_a16(2 * BARRIER_SLOTS * 8) + 2 * _a16((Mc + 1) * H * 4)
             + _a16(Mc * H * 4) + _a16(H * 4) + _a16(F * 4) + _a16(F * 2)
             + _a16(F * 4 * (2 if exact_kvg else 1)) + _a16(groups * F * 4))
    best = None
    for stages in range(1, MAX_STAGES + 1):
        smem = fixed + stages * stage
        if smem > SMEM_LIMIT:
            break
        blocks = min(MAX_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVED))
        key = (blocks, stages)
        if best is None or key > best[0]:
            best = (key, stages)
    if best is None:
        raise ValueError(
            f"one stage of {stage} bytes (Mc={Mc}, F={F}, {quant or 'exact'} "
            f"rows of {row_bytes} bytes) and {fixed} bytes of scratch exceed "
            f"the {SMEM_LIMIT} bytes of shared memory of a block")
    stages = best[1]
    return StagePlan(stages, stage, fixed, fixed + stages * stage)
