"""The launch plan of the staged kernels K2 and K4 (ops/staging.py): stage
count and dynamic shared memory for every shape on the decode paths, the
refusal of a shape that cannot fit, and the CPU dispatch that never
reaches the plan. Runs on the CPU."""
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
    assert plan == StagePlan(1, stage, fixed, fixed + stage)
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


@pytest.mark.parametrize("quant,cesz,qesz,Mc,F,H", [
    (None, 4, 4, 64, 768, 12),       # f32 rows, 64 slots: 393 KB a slab
    (None, 2, 2, 96, 768, 12),
    ("int8", 1, 2, 128, 1024, 16),
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
    """A shape no stage can hold still runs on the CPU (the plain version
    needs no plan), and no launch counter moves."""
    rng = np.random.default_rng(0)
    Bq, Nq, L, Mc, H, D = 1, 2, 2, 72, 12, 64
    F = H * D
    if quant is None:
        with pytest.raises(ValueError):
            stage_plan(None, 4, 4, Mc, F, H)
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
