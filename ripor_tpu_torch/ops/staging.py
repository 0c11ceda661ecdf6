"""Launch plan of the staged attention kernels, K2, K4, K5 and K8.

The kernels (csrc/attend_staged.cuh) stage each beam's layer slab in a
ring of shared-memory stages that persistent blocks fill with bulk async
copies: K2 and K4 the Mc cache rows of K|V-merged rows (with the beam's q
and kv_new rows, and, in K4's in-kernel quantize mode, kvg's exact row),
K5 and K8 the beam's K plane and V plane ([Mc, F] each; with q, and K5's
k_new and v_new). ``stage_plan`` picks the ring's depth, the slots a stage
holds and the dynamic shared memory that asks for; the wrappers pass them
to the C entries, which recompute the same layout (``make_layout``) and
refuse a launch whose plan differs.

The depth trades against blocks per SM: a block computes one beam at a
time while its other stages load, and more beams computing at once beat a
deeper ring. So the plan keeps the most blocks an SM can hold and, among
equals, the most stages. Measured with chip_stage_bench.py on the H100 at
t5-base, B=8, N=1000 (PERF.md, section 6): int4 rows at Mc=32 run 0.268 ms
(K2) with one stage in three blocks and 0.300 with two in two; int8 0.357
with one stage in two blocks and 0.516 with three in one; bf16 0.333 with
two stages in one block and 0.453 with one.

Slot chunks. Where one stage cannot hold a beam's whole slab (t5-3b widths
in bf16 or int8 rows, t5-large in f32), a stage holds ``chunk_slots`` < Mc
slots and the kernel streams the slab through the ring in chunks, twice: a
score pass and a V pass (planes: the K chunks, then the V chunks). Every
load carries the beam's q and kv_new rows, so the plan takes the largest
chunk that fits (the fewest loads), then the most stages. A shape where
even one slot does not fit beside the per-block scratch raises
ValueError: the kernel does not run, and nothing else runs in its place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SMEM_LIMIT = 232_448       # dynamic shared memory of one block, H100
SM_SMEM = 233_472          # shared memory of one SM (228 KB)
BLOCK_RESERVED = 1_024     # shared memory the SM reserves per block
MAX_STAGES = 2             # ring depth (at most the kernels' kMaxStages)
BARRIER_SLOTS = 3          # kMaxStages (chip_stage_bench.py tries 3)
# registers: __launch_bounds__(288, 3) holds the whole-slab instances to 72
# a thread (ptxas, chip_smoke.py phase 1), so three blocks share an SM's
# 65,536 (the chunked instances fill a block's shared memory: one block)
MAX_BLOCKS = 3
CONSUMERS = 256            # consumer threads of a block (kConsumers)
SCALE_COLS = 128           # scale tail of a quantized row (row_codec.cuh)


@dataclasses.dataclass(frozen=True)
class StagePlan:
    stages: int
    stage_bytes: int       # one stage: rows (or planes), q, kv_new, kvg's row
    fixed_bytes: int       # barriers and the per-block scratch
    smem_bytes: int        # fixed_bytes + stages * stage_bytes
    chunk_slots: int       # slots a stage holds: Mc unless the slab is chunked
    chunks: int            # chunks of a beam's slab (1: staged whole)


def _a16(n: int) -> int:
    return (n + 15) // 16 * 16


def stage_plan(quant: Optional[str], cache_esz: int, q_esz: int, Mc: int,
               F: int, H: int, exact_kvg: bool = False, planes: bool = False,
               new: bool = True) -> StagePlan:
    """Stages, slots a stage holds and shared-memory bytes of one launch.

    quant: None (exact rows or planes of ``cache_esz`` bytes), "int8" or
    "int4"; q_esz: bytes of q's dtype; exact_kvg: K4's in-kernel quantize
    mode (exact kvg rows into a quantized cache), whose kvg row is staged
    too; planes: separate K and V planes (K5, K8) rather than K|V-merged
    rows (K2, K4); new: position t's k/v rows are staged (all but K8).
    """
    if planes:
        row_bytes = F * cache_esz             # one plane's row
    else:
        row_bytes = {None: 2 * F * cache_esz, "int8": 2 * F + SCALE_COLS,
                     "int4": F + SCALE_COLS}[quant]
    vec = (F // H) % 16 == 0
    cols = 16 if quant is not None else 16 // cache_esz   # per 16-byte chunk
    ncv = F // cols

    def fixed(chunked):
        groups = ((1 if ncv >= CONSUMERS else CONSUMERS // ncv) if vec
                  else int(chunked))
        return (_a16(2 * BARRIER_SLOTS * 8) + 2 * _a16((Mc + 1) * H * 4)
                + _a16(Mc * H * 4) + _a16(H * 4) + _a16(F * 4) + _a16(F * 2)
                + _a16(F * 4 * (2 if exact_kvg else 1))
                + _a16(groups * F * 4))

    def stage(slots):                 # slots < Mc: a chunk (of one plane)
        rows = _a16(slots * row_bytes) * (2 if planes and slots == Mc else 1)
        return (rows + _a16(F * q_esz) + (_a16(2 * F * q_esz) if new else 0)
                + (_a16(2 * F * q_esz) if exact_kvg else 0))

    whole = fixed(False)
    best = None
    for stages in range(1, MAX_STAGES + 1):
        smem = whole + stages * stage(Mc)
        if smem > SMEM_LIMIT:
            break
        blocks = min(MAX_BLOCKS, SM_SMEM // (smem + BLOCK_RESERVED))
        if best is None or (blocks, stages) > best[0]:
            best = ((blocks, stages), stages, Mc)
    fixed_bytes = whole
    if best is None:                          # slot chunks
        fixed_bytes = fixed(True)
        for stages in range(1, MAX_STAGES + 1):
            slots = next((m for m in range(Mc - 1, 0, -1)
                          if fixed_bytes + stages * stage(m)
                          <= SMEM_LIMIT), None)
            if slots is None:
                break
            key = (-(-Mc // slots), -stages)  # fewest chunks, then stages
            if best is None or key < best[0]:
                best = (key, stages, slots)
    if best is None:
        raise ValueError(
            f"a stage of one slot ({stage(1)} bytes: Mc={Mc}, F={F}, "
            f"{'planes' if planes else 'rows'} of {row_bytes} bytes, "
            f"{quant or 'exact'}) and {fixed_bytes} bytes of scratch exceed "
            f"the {SMEM_LIMIT} bytes of shared memory of a block")
    _, stages, slots = best
    stage_bytes = stage(slots)
    return StagePlan(stages, stage_bytes, fixed_bytes,
                     fixed_bytes + stages * stage_bytes, slots,
                     -(-Mc // slots))
