"""The launch plan of the staged kernels K2, K4, K5 and K8
(ops/staging.py): stage count, slots a stage holds and dynamic shared
memory for every shape on the decode paths and at the widths of every
configuration the repo defines (slot chunks where one stage cannot hold a
slab), the refusal of a shape that cannot fit even one slot, and the CPU
dispatch that never reaches the plan. Runs on the CPU."""
import numpy as np
import pytest
import torch

from ripor_tpu_torch.ops import (KERNEL_LAUNCHES, quantize_rows_int4_plain,
                                 quantize_rows_plain, step_attend_reorder,
                                 step_attention_seq)
from ripor_tpu_torch.ops.attend_reorder import SCALE_COLS, row_width
from ripor_tpu_torch.ops.staging import (MAX_STAGES, SMEM_LIMIT, StagePlan,
                                         stage_plan)
from ripor_tpu_torch.ops import staging

# (quant, cache element bytes, q element bytes): the cache types of the
# paths (int4 and int8 rows with bf16 or f32 q, exact bf16 and f32 rows)
KINDS = {"int4": ("int4", 1, 2), "int8": ("int8", 1, 2),
         "bf16": (None, 2, 2), "f32": (None, 4, 4),
         "int4 f32 q": ("int4", 1, 4)}
T5_BASE = (768, 12)                 # F, H
RIPOR_SMALL = (64, 4)
SEGMENTS_T5 = (8, 16, 24, 32)       # cache_segments=4 at M=32
SEGMENTS_SMALL = (2, 4, 6, 8)       # cache_segments=4 at M=8


def _blocks(smem):
    return min(staging.MAX_BLOCKS,
               staging.SM_SMEM // (smem + staging.BLOCK_RESERVED))


def _check(plan: StagePlan):
    assert 1 <= plan.stages <= MAX_STAGES
    assert plan.smem_bytes == plan.fixed_bytes + plan.stages * plan.stage_bytes
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stage_bytes % 16 == 0 and plan.fixed_bytes % 16 == 0
    assert plan.chunks == 1
    # no other depth fits more blocks on an SM, or as many with more stages
    b = _blocks(plan.smem_bytes)
    for s in range(1, MAX_STAGES + 1):
        smem = plan.fixed_bytes + s * plan.stage_bytes
        if smem <= SMEM_LIMIT:
            assert (_blocks(smem), s) <= (b, plan.stages)


@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("Mc", SEGMENTS_T5)
def test_plan_t5_base(kernel, kind, Mc):
    quant, cesz, qesz = KINDS[kind]
    F, H = T5_BASE
    plan = stage_plan(quant, cesz, qesz, Mc, F, H,
                      exact_kvg=kernel == "K4" and quant is not None)
    _check(plan)
    rw = row_width(F, quant) * (cesz if quant is None else 1)
    assert plan.stage_bytes >= Mc * rw + 3 * F * qesz
    if kind == "f32" and Mc == 32:
        assert plan.stages == 1          # 196,608-byte slab: one stage


@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("Mc", SEGMENTS_SMALL)
def test_plan_ripor_small(kernel, kind, Mc):
    quant, cesz, qesz = KINDS[kind]
    F, H = RIPOR_SMALL
    plan = stage_plan(quant, cesz, qesz, Mc, F, H,
                      exact_kvg=kernel == "K4" and quant is not None)
    _check(plan)


def test_plan_layout_pinned():
    """The plans of the main paths' Mc=32 launches, byte for byte. K2
    int4: barriers 48, biases and scores 2 x 1584, probabilities 1536, pn
    48, q 3072 + 1536, position t's products 3072, V partials 5 x 768
    floats; a stage holds the 28,672-byte slab, q (1536) and kv_new
    (3072); one stage in each of three blocks an SM. K2 int8: one
    57,856-byte stage, two blocks. K2 bf16: two 102,912-byte stages, one
    block. K2 int4 at Mc=8: two stages, three blocks."""
    fixed = 48 + 2 * 1584 + 1536 + 48 + 3072 + 1536 + 3072 + 5 * 768 * 4
    stage = 28_672 + 1536 + 3072
    plan = stage_plan("int4", 1, 2, 32, 768, 12)
    assert plan == StagePlan(1, stage, fixed, fixed + stage, 32, 1)
    assert _blocks(plan.smem_bytes) == 3
    plan = stage_plan("int8", 1, 2, 32, 768, 12)
    assert (plan.stages, plan.stage_bytes) == (1, 57_856)
    assert _blocks(plan.smem_bytes) == 2
    plan = stage_plan(None, 2, 2, 32, 768, 12)
    assert (plan.stages, plan.stage_bytes) == (2, 102_912)
    assert _blocks(plan.smem_bytes) == 1
    plan = stage_plan("int4", 1, 2, 8, 768, 12)
    assert plan.stages == 2 and _blocks(plan.smem_bytes) == 3
    assert staging.SCALE_COLS == SCALE_COLS


# (quant, cache element bytes, q element bytes) of the rows the paths and
# the configurations use; K5 and K8 take exact planes of f32 or bf16
ROW_KINDS = {"f32": (None, 4, 4), "bf16": (None, 2, 2),
             "int8": ("int8", 1, 2), "int4": ("int4", 1, 2)}
# F = H * d_kv, H of each configuration in models/config.py
WIDTHS = {"t5-small": (512, 8), "t5-base": (768, 12),
          "t5-large": (1024, 16), "t5-3b": (4096, 32)}


def _a16(n):
    return -(-n // 16) * 16


def _expected(quant, cesz, qesz, Mc, F, H, exact_kvg=False, planes=False,
              new=True):
    """The layout of csrc/attend_staged.cuh make_layout, written out: the
    per-block scratch and one stage's bytes at ``slots`` slots, for the
    plan's depth and chunk size to be checked against."""
    row = (F * cesz if planes else
           {None: 2 * F * cesz, "int8": 2 * F + 128, "int4": F + 128}[quant])
    cols = 16 // cesz if quant is None else 16
    G = max(1, 256 // (F // cols)) if (F // H) % 16 == 0 else None

    def fixed(chunked):
        groups = G if G is not None else int(chunked)
        return (48 + 2 * _a16((Mc + 1) * H * 4) + _a16(Mc * H * 4)
                + _a16(4 * H) + 4 * F + 2 * F + 4 * F * (1 + exact_kvg)
                + 4 * groups * F)

    def stage(slots):
        whole = slots == Mc
        return (_a16(slots * row) * (2 if planes and whole else 1) + F * qesz
                + 2 * F * qesz * new + 2 * F * qesz * exact_kvg)
    return fixed, stage


def _check_pinned(plan, args, kw):
    Mc = args[3]
    fixed, stage = _expected(*args, **kw)
    chunked = plan.chunk_slots < Mc
    assert plan.fixed_bytes == fixed(chunked)
    assert plan.stage_bytes == stage(plan.chunk_slots)
    assert plan.smem_bytes == plan.fixed_bytes + plan.stages * plan.stage_bytes
    assert plan.smem_bytes <= SMEM_LIMIT and 1 <= plan.stages <= MAX_STAGES
    assert plan.chunks == -(-Mc // plan.chunk_slots)
    if not chunked:
        return
    # the whole slab fits no stage; no chunk of more slots fits this depth,
    # and no depth takes fewer chunks
    assert fixed(False) + stage(Mc) > SMEM_LIMIT
    assert (plan.fixed_bytes + plan.stages * stage(plan.chunk_slots + 1)
            > SMEM_LIMIT)
    for s in range(1, MAX_STAGES + 1):
        best = max((m for m in range(1, Mc)
                    if plan.fixed_bytes + s * stage(m) <= SMEM_LIMIT),
                   default=None)
        if best is not None:
            assert (-(-Mc // best), -s) >= (plan.chunks, -plan.stages)


@pytest.mark.parametrize("Mc", [1, 8, 32])
@pytest.mark.parametrize("kind", list(ROW_KINDS))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_plan_every_configuration_width(width, kind, Mc):
    """K2 and K4 (both kvg modes) on every row type, and K5 and K8 on the
    exact planes, at the widths of every configuration: a plan exists and
    its layout is the kernels'."""
    F, H = WIDTHS[width]
    quant, cesz, qesz = ROW_KINDS[kind]
    cases = [({}), (dict(exact_kvg=quant is not None))]
    if quant is None:
        cases += [dict(planes=True), dict(planes=True, new=False)]
    for kw in cases:
        args = (quant, cesz, qesz, Mc, F, H)
        _check_pinned(stage_plan(*args, **kw), args, kw)


@pytest.mark.parametrize("quant,cesz,qesz,Mc,F,H,chunk_slots,chunks", [
    (None, 4, 4, 64, 768, 12, 33, 2),    # f32 rows, 64 slots: 393 KB a slab
    (None, 2, 2, 96, 768, 12, 65, 2),
    ("int8", 1, 2, 128, 1024, 16, 80, 2),
])
def test_plan_chunks_what_one_stage_cannot_hold(quant, cesz, qesz, Mc, F, H,
                                                chunk_slots, chunks):
    """Slabs larger than one stage stream in slot chunks: the largest chunk
    that fits, in one stage."""
    plan = stage_plan(quant, cesz, qesz, Mc, F, H)
    assert (plan.chunk_slots, plan.chunks, plan.stages) == (chunk_slots,
                                                            chunks, 1)
    assert plan.smem_bytes <= SMEM_LIMIT
    _check_pinned(plan, (quant, cesz, qesz, Mc, F, H), {})


@pytest.mark.parametrize("kernel,args,kw,plan", [
    # K2/K4 at t5-3b: bf16 rows (548,864 B a slab), int8 rows
    ("K2 bf16 t5-3b", (None, 2, 2, 32, 4096, 32), {}, (1, 8, 4)),
    ("K4 bf16 t5-3b", (None, 2, 2, 32, 4096, 32), {}, (1, 8, 4)),
    ("K2 int8 t5-3b", ("int8", 1, 2, 32, 4096, 32), {}, (1, 16, 2)),
    ("K4 int8 t5-3b", ("int8", 1, 2, 32, 4096, 32), dict(exact_kvg=True),
     (1, 12, 3)),
    # f32 rows and planes at t5-large
    ("K2 f32 t5-large", (None, 4, 4, 32, 1024, 16), {}, (1, 24, 2)),
    ("K5 f32 t5-large", (None, 4, 4, 32, 1024, 16), dict(planes=True),
     (2, 22, 2)),
    ("K8 f32 t5-large", (None, 4, 4, 32, 1024, 16),
     dict(planes=True, new=False), (2, 24, 2)),
    # bf16 planes at t5-3b
    ("K5 bf16 t5-3b", (None, 2, 2, 32, 4096, 32), dict(planes=True),
     (1, 16, 2)),
    ("K8 bf16 t5-3b", (None, 2, 2, 32, 4096, 32),
     dict(planes=True, new=False), (1, 18, 2)),
    # the main path's planes at t5-base: whole, f32 in one stage only
    ("K5 bf16 t5-base", (None, 2, 2, 32, 768, 12), dict(planes=True),
     (2, 32, 1)),
    ("K5 f32 t5-base", (None, 4, 4, 32, 768, 12), dict(planes=True),
     (1, 32, 1)),
    ("K8 bf16 t5-base", (None, 2, 2, 32, 768, 12),
     dict(planes=True, new=False), (2, 32, 1)),
])
def test_plan_pinned_oversized_and_planes(kernel, args, kw, plan):
    """(stages, slots a stage holds, chunks) of the oversized shapes that
    chip_smoke.py runs, and of K5/K8's main-path planes: K5 in bf16 at
    Mc=32 takes two 102,912-byte stages (K and V planes, q, k_new, v_new),
    in f32 one 205,824-byte stage."""
    got = stage_plan(*args, **kw)
    assert (got.stages, got.chunk_slots, got.chunks) == plan
    _check_pinned(got, args, kw)
    if kernel == "K5 bf16 t5-base":
        assert got.stage_bytes == 102_912
    if kernel == "K5 f32 t5-base":
        assert got.stage_bytes == 205_824 and got.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("quant,cesz,qesz,Mc,F,H", [
    (None, 4, 4, 32, 16384, 128),    # q and the scratch alone: 458 KB
])
def test_plan_refuses_what_cannot_fit(quant, cesz, qesz, Mc, F, H):
    with pytest.raises(ValueError, match="shared memory"):
        stage_plan(quant, cesz, qesz, Mc, F, H)


def _rows(quant, lead, F, H, rng, dtype=torch.float32):
    kv = torch.from_numpy(rng.standard_normal((*lead, 2 * F)).astype(
        np.float32))
    if quant == "int8":
        return quantize_rows_plain(kv, H)
    if quant == "int4":
        return quantize_rows_int4_plain(kv, H)
    return kv.to(dtype)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_cpu_tensors_take_the_plain_version(quant):
    """A shape whose slab no stage can hold runs on the CPU (the plain
    version needs no plan), and no launch counter moves."""
    rng = np.random.default_rng(0)
    Bq, Nq, L, Mc, H, D = 1, 2, 2, 72, 12, 64
    F = H * D
    if quant is None:
        assert stage_plan(None, 4, 4, Mc, F, H).chunks > 1
    q = torch.from_numpy(rng.standard_normal((Bq, Nq, F)).astype(np.float32))
    kv_new = torch.from_numpy(
        rng.standard_normal((Bq, Nq, 2 * F)).astype(np.float32))
    bias_hist = torch.zeros(Mc, H)
    bias_new = torch.zeros(1, H)
    before = dict(KERNEL_LAUNCHES)
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, rng)
    out = step_attention_seq(q, kv_new, cache, 1, bias_hist, bias_new, H,
                             quant)
    attn = out[0] if quant else out
    assert attn.shape == (Bq, Nq, F) and torch.isfinite(attn).all()
    merged = cache.permute(2, 0, 1, 3, 4).contiguous()
    kvg = torch.from_numpy(
        rng.standard_normal((Bq, Nq, L * 2 * F)).astype(np.float32))
    src = torch.zeros(Bq, Nq, dtype=torch.int32)
    attn, dst = step_attend_reorder(q, kv_new, kvg, merged,
                                    torch.zeros_like(merged), src, 1, 5,
                                    bias_hist, bias_new, H)
    assert torch.isfinite(attn).all()
    assert torch.equal(dst[1, :, :, :4], merged[1][:, src[0].long()][:, :, :4])
    assert KERNEL_LAUNCHES == before


# ---------------------------------------------------------------------------
# K2's per-head schedule (staging.heads_plan): int8/int4 rows, bf16 q, D a
# multiple of 16, each slab staged whole
# ---------------------------------------------------------------------------

def _heads_expected(quant, Mc, F, H):
    """csrc/step_attention_seq.cu make_heads_layout, written out: the
    per-block bytes (8 barrier pairs, biases, each warp's word a slot and
    its head's q pairs) and one stage's (rows at an odd number of 16-byte
    chunks, q, kv_new)."""
    D = F // H
    rw = {"int8": 2 * F, "int4": F}[quant] + 128
    stride = rw if rw // 16 % 2 else rw + 16
    warps = -(-H // -(-H // 12))
    fixed = 128 + _a16((Mc + 1) * H * 4) + warps * (_a16(4 * Mc) + 2 * D)
    return warps, stride, fixed, _a16(Mc * stride) + 2 * F + 4 * F


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("Mc", [1, 4, 8, 12, 16, 24, 32, 40])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_heads_plan_layout(width, quant, Mc):
    """The plan's bytes are its layout's: fixed bytes and stages sum to its
    shared memory, which fits a block; no other depth holds more beams an
    SM (three a block at most), or as many with two stages a block where
    the plan has one, or in more blocks, or in as many blocks with more
    stages."""
    F, H = WIDTHS[width]
    plan = staging.heads_plan(quant, 2, Mc, F, H)
    warps, stride, fixed, stage = _heads_expected(quant, Mc, F, H)
    if fixed + stage > SMEM_LIMIT:
        assert plan is None
        return
    assert (plan.warps, plan.row_stride) == (warps, stride)
    assert (plan.fixed_bytes, plan.stage_bytes) == (fixed, stage)
    assert plan.smem_bytes == plan.fixed_bytes + plan.stages * plan.stage_bytes
    assert plan.smem_bytes <= SMEM_LIMIT
    assert 1 <= plan.stages <= staging.HEADS_MAX_STAGES
    assert plan.row_stride % 32 == 16      # eight rows, eight bank groups
    blocks = min(staging.HEADS_MAX_BLOCKS,
                 staging.SM_SMEM // (plan.smem_bytes + staging.BLOCK_RESERVED))
    assert plan.blocks == blocks >= 1
    for s in range(1, staging.HEADS_MAX_STAGES + 1):
        smem = fixed + s * stage
        if smem <= SMEM_LIMIT:
            b = min(staging.HEADS_MAX_BLOCKS,
                    staging.SM_SMEM // (smem + staging.BLOCK_RESERVED))
            assert (b * min(s, 3), min(s, 2), b, s) <= (
                blocks * min(plan.stages, 3), min(plan.stages, 2), blocks,
                plan.stages)


@pytest.mark.parametrize("Mc", range(1, 33))
def test_heads_plan_rings_t5_base_int4(Mc):
    """At t5-base with int4 rows every segment size keeps six or more beams
    staged an SM, two or more a block, in three blocks (the staged core
    held one stage in each of three blocks at Mc = 32)."""
    plan = staging.heads_plan("int4", 2, Mc, 768, 12)
    assert plan.blocks == 3 and plan.stages >= 2
    assert plan.blocks * plan.stages >= 6
    assert plan.smem_bytes <= SMEM_LIMIT


def test_heads_plan_pinned():
    """t5-base, Mc = 32: int4 rows of 896 bytes at a 912-byte stride, 12
    warps, two 33,792-byte stages in each of three blocks; int8 rows three
    58,368-byte stages in one block (rather than one in each of three)."""
    fixed = 128 + 1584 + 12 * (128 + 128)
    plan = staging.heads_plan("int4", 2, 32, 768, 12)
    assert plan == staging.HeadsPlan(12, 2, 33_792, fixed,
                                     fixed + 2 * 33_792, 912, 3)
    plan = staging.heads_plan("int8", 2, 32, 768, 12)
    assert (plan.stages, plan.stage_bytes, plan.blocks) == (3, 58_368, 1)


@pytest.mark.parametrize("args,why", [
    ((None, 2, 32, 768, 12), "exact rows"),
    (("int4", 4, 32, 768, 12), "f32 q"),
    (("int4", 2, 8, 48, 2), "D = 24"),
    (("int4", 2, 8, 40, 2), "D = 20"),
    (("int4", 2, 8, 512, 2), "D = 256"),
    (("int8", 2, 32, 4096, 32), "a slab no stage holds"),
])
def test_heads_plan_declines(args, why):
    assert staging.heads_plan(*args) is None, why


@pytest.mark.parametrize("H,warps", [(1, 1), (2, 2), (4, 4), (12, 12),
                                     (16, 8), (20, 10), (32, 11)])
def test_heads_warps(H, warps):
    assert staging.heads_warps(H) == warps


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("Mc", SEGMENTS_T5 + (4, 12))
def test_seq_schedule_choice(kind, Mc):
    """K2 takes the per-head schedule for int8/int4 rows with bf16 q, and
    stage_plan's plan, as it stands, for exact rows and f32 q."""
    from ripor_tpu_torch.ops.megarow import seq_schedule
    quant, cesz, qesz = KINDS[kind]
    schedule, plan = seq_schedule(quant, cesz, qesz, Mc, 768, 12)
    if quant is not None and qesz == 2:
        assert schedule == "heads"
        assert plan == staging.heads_plan(quant, qesz, Mc, 768, 12)
    else:
        assert schedule == "core"
        assert plan == stage_plan(quant, cesz, qesz, Mc, 768, 12)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_cpu_tensors_count_no_schedule(quant):
    """On the CPU the plain version runs under either schedule's shapes,
    and no schedule counter moves."""
    from ripor_tpu_torch.ops import SCHEDULE_LAUNCHES
    rng = np.random.default_rng(1)
    Bq, Nq, L, Mc, H, D = 1, 3, 2, 8, 4, 16
    F = H * D
    q = torch.from_numpy(rng.standard_normal((Bq, Nq, F)).astype(
        np.float32)).bfloat16()
    kv_new = torch.from_numpy(rng.standard_normal(
        (Bq, Nq, 2 * F)).astype(np.float32)).bfloat16()
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, rng)
    assert staging.heads_plan(quant, 2, Mc, F, H) is not None
    before = dict(SCHEDULE_LAUNCHES)
    attn, kvq = step_attention_seq(q, kv_new, cache, 1, torch.zeros(Mc, H),
                                   torch.zeros(1, H), H, quant)
    assert attn.dtype == torch.bfloat16 and torch.isfinite(attn.float()).all()
    assert kvq.shape == (Bq, Nq, cache.shape[-1])
    assert SCHEDULE_LAUNCHES == before
