"""K2's two consumer schedules on the card: the per-head schedule (one warp
a (beam, head); int8/int4 rows, bf16 q, D a multiple of 16, a slab one
stage holds) against the plain version at the staged kernels' shapes, Mc
1-40 and the 4-16 slots of the 16x1024 configuration at F = 768, both row
codecs, K2 and K2' (mxu_math), with and without the emitted cache rows;
and the cases that keep the staged core (exact rows, f32 q, chunked slabs,
D of 20 and 24). Each call is one launch, counted under its schedule.
Marked ``cuda``: without a CUDA device every test here skips. On the card:
``python -m pytest -q --noconftest
tests/test_torch_step_attention_heads_cuda.py``.
"""
import pytest
import torch

from ripor_tpu_torch.ops import (KERNEL_LAUNCHES, SCHEDULE_LAUNCHES,
                                 quantize_rows_int4_plain,
                                 quantize_rows_plain, step_attention_seq,
                                 step_attention_seq_plain)

pytestmark = pytest.mark.cuda

STAGED_SHAPES = [           # (B, N, Mc, H, D), as test_torch_kernels_cuda's
    (1, 1, 8, 12, 64),
    (2, 40, 1, 12, 64),
    (3, 1000, 24, 12, 64),
    (8, 1000, 32, 12, 64),
    (2, 24, 8, 4, 16),
    (3, 50, 32, 4, 16),
    (2, 30, 8, 2, 24),      # D = 24 and 20: the staged core
    (2, 30, 8, 2, 20),
]
# the 16x1024 configuration's slots at t5-base width, slots past one warp's
# 32 lanes, slot counts of no multiple of four, and t5-3b's head width
HEADS_SHAPES = STAGED_SHAPES + [(8, 1000, Mc, 12, 64) for Mc in (4, 8, 12,
                                                                 16)] \
    + [(2, 30, 40, 12, 64), (2, 30, 5, 12, 64), (2, 30, 7, 8, 128)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _rows(quant, lead, F, H, gen, dtype=torch.bfloat16):
    kv = torch.randn(*lead, 2 * F, generator=gen, device="cuda")
    if quant == "int8":
        return quantize_rows_plain(kv, H)
    if quant == "int4":
        return quantize_rows_int4_plain(kv, H)
    return kv.to(dtype)


def _inputs(Bq, Nq, F, H, Mc, t, gen, dtype=torch.bfloat16):
    q = torch.randn(Bq, Nq, F, generator=gen, device="cuda").to(dtype)
    kv_new = torch.randn(Bq, Nq, 2 * F, generator=gen, device="cuda").to(dtype)
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    return q, kv_new, bias_hist, bias_new


def _run(args, mxu, emit, schedule):
    """Both versions; the outputs compared, one launch counted under its
    body and ``schedule``."""
    body = "step_attention_seq_mxu" if mxu else "step_attention_seq"
    before, sched = dict(KERNEL_LAUNCHES), dict(SCHEDULE_LAUNCHES)
    a = step_attention_seq(*args, mxu_math=mxu)
    b = step_attention_seq_plain(*args, mxu_math=mxu)
    torch.cuda.synchronize()
    if emit:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    assert {k: v - before[k] for k, v in KERNEL_LAUNCHES.items()
            if v != before[k]} == {body: 1}
    assert {k: v - sched[k] for k, v in SCHEDULE_LAUNCHES.items()
            if v != sched[k]} == {f"step_attention_seq.{schedule}": 1}


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D", HEADS_SHAPES)
def test_heads_schedule_matches_plain(Bq, Nq, Mc, H, D, quant, mxu, emit,
                                      gen):
    """Quantized rows with bf16 q: the per-head schedule where D is a
    multiple of 16, the staged core where it is not."""
    F, L = H * D, 2
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
    t = max(Mc - 1, 1)
    q, kv_new, bias_hist, bias_new = _inputs(Bq, Nq, F, H, Mc, t, gen)
    args = (q, kv_new, cache, 1, bias_hist, bias_new, H,
            quant if emit else None)
    _run(args, mxu, emit, "heads" if D % 16 == 0 else "core")


@pytest.mark.parametrize("case", ["bf16 rows", "f32 rows", "int4 f32 q",
                                  "int8 chunked", "int4 D=24"])
def test_core_schedule_cases(case, gen):
    """Exact rows, f32 q, a slab no stage holds (int8 rows at t5-3b width)
    and a head width of no 16-byte multiple keep the staged core."""
    Bq, Nq, Mc, H, D = 2, 50, 32, 12, 64
    quant, dtype = "int4", torch.bfloat16
    if case == "bf16 rows":
        quant = None
    elif case == "f32 rows":
        quant, dtype = None, torch.float32
    elif case == "int4 f32 q":
        dtype = torch.float32
    elif case == "int8 chunked":
        quant, H, D = "int8", 32, 128
    else:
        H, D = 2, 24
    F = H * D
    cache = _rows(quant, (Bq, Nq, 1, Mc), F, H, gen, dtype)
    q, kv_new, bias_hist, bias_new = _inputs(Bq, Nq, F, H, Mc, Mc - 3, gen,
                                             dtype)
    args = (q, kv_new, cache, 0, bias_hist, bias_new, H, quant)
    _run(args, False, quant is not None, "core")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_emitted_exponents_at_their_edges(quant, gen):
    """The emitted rows' exponents come from the absmax's bits: groups whose
    absmax sits on qmax 2^k, one bf16 step either side, at zero, below
    1e-30 and near bf16's top keep the plain version's rows bit for bit."""
    Bq, Nq, Mc, H, D = 2, 64, 8, 12, 64
    F = H * D
    qmax = 7.0 if quant == "int4" else 127.0
    edges = []
    for k in (-120, -20, -5, -1, 0, 1, 4, 10, 100):
        x = torch.tensor(qmax * 2.0 ** k, dtype=torch.bfloat16)
        up = (x.view(torch.int16) + 1).view(torch.bfloat16)
        down = (x.view(torch.int16) - 1).view(torch.bfloat16)
        edges += [x.item(), up.item(), down.item()]
    edges += [0.0, 1e-35, 3e38]
    cache = _rows(quant, (Bq, Nq, 1, Mc), F, H, gen)
    q, kv_new, bias_hist, bias_new = _inputs(Bq, Nq, F, H, Mc, Mc - 1, gen)
    groups = kv_new.view(Bq * Nq, 2 * H, D)
    for i in range(Bq * Nq):
        for gi in range(2 * H):
            e = edges[(i * 2 * H + gi) % len(edges)]
            groups[i, gi] = groups[i, gi].clamp(-abs(e), abs(e))
            groups[i, gi, (i + gi) % D] = -e if (i + gi) % 2 else e
    args = (q, kv_new, cache, 0, bias_hist, bias_new, H, quant)
    (a, aq), (b, bq) = (step_attention_seq(*args),
                        step_attention_seq_plain(*args))
    torch.cuda.synchronize()
    assert torch.equal(aq, bq)
