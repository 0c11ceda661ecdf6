"""The port's CUDA kernels (K1-K8) against their plain PyTorch
versions, on the card. Marked ``cuda``: without a CUDA device every test
here skips. On the card: ``python -m pytest
tests/test_torch_kernels_cuda.py -q`` (the main-path shapes are checked
by chip_smoke.py)."""
import pytest
import torch

from ripor_tpu_torch.ops import (KERNEL_LAUNCHES, beam_gather_blocks,
                                 beam_gather_blocks_plain, beam_gather_rows,
                                 beam_gather_rows_plain, beam_gather_update,
                                 beam_gather_update_plain,
                                 quantize_rows_int4_plain,
                                 quantize_rows_plain, reorder_cache_all,
                                 reorder_cache_all_plain,
                                 step_attend_reorder,
                                 step_attend_reorder_plain,
                                 step_attention, step_attention_fused,
                                 step_attention_fused_plain,
                                 step_attention_plain, step_attention_seq,
                                 step_attention_seq_plain)

pytestmark = pytest.mark.cuda

B, N, L, H, D, Mc = 2, 40, 3, 12, 64, 8
F = H * D


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _cache(quant, gen):
    kv = torch.randn(B, N, L, Mc, 2 * F, generator=gen, device="cuda")
    if quant == "int8":
        return quantize_rows_plain(kv, H)
    if quant == "int4":
        return quantize_rows_int4_plain(kv, H)
    return kv.bfloat16()


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_kernels_match_plain(quant, gen):
    cache = _cache(quant, gen)
    RW = cache.shape[-1]
    src = torch.randint(0, N, (B, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    kvg = (quantize_rows_plain if quant == "int8" else
           quantize_rows_int4_plain if quant == "int4" else
           (lambda x, h: x.bfloat16()))(
        torch.randn(B, N, L, 2 * F, generator=gen, device="cuda"),
        H).reshape(B, N, L * RW)
    before = dict(KERNEL_LAUNCHES)
    got = reorder_cache_all(kvg, cache, torch.empty_like(cache), src, 4)
    want = reorder_cache_all_plain(kvg, cache, torch.empty_like(cache), src,
                                   4)
    assert torch.equal(got, want)
    q = torch.randn(B, N, F, generator=gen, device="cuda").bfloat16()
    kv_new = torch.randn(B, N, 2 * F, generator=gen,
                         device="cuda").bfloat16()
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[5:] = -1e9
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    args = (q, kv_new, got, 1, bias_hist, bias_new, H, quant)
    a, b = step_attention_seq(*args), step_attention_seq_plain(*args)
    if quant:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    x = got.reshape(B, N, -1)
    assert torch.equal(beam_gather_rows(x, src),
                       beam_gather_rows_plain(x, src))
    torch.cuda.synchronize()
    megarow = ("reorder_cache_all", "step_attention_seq", "beam_gather_rows")
    assert all(KERNEL_LAUNCHES[k] == before[k] + 1 for k in megarow)


def _merged_cache(quant, gen):
    """A layer-major [L, B, N, Mc, RW] cache of valid rows."""
    return _cache(quant, gen).permute(2, 0, 1, 3, 4).contiguous()


@pytest.mark.parametrize("t,write_back", [(0, True), (5, True), (5, False)])
@pytest.mark.parametrize("quant,kvg_q8", [(None, False), ("int8", False),
                                          ("int8", True), ("int4", False)])
def test_step_attend_reorder_matches_plain(quant, kvg_q8, t, write_back,
                                           gen):
    cache = _merged_cache(quant, gen)
    src = torch.randint(0, N, (B, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    kvg = torch.randn(B, N, L, 2 * F, generator=gen, device="cuda")
    kvg = (quantize_rows_plain(kvg, H) if kvg_q8
           else kvg.bfloat16()).reshape(B, N, -1)
    q = torch.randn(B, N, F, generator=gen, device="cuda").bfloat16()
    kv_new = torch.randn(B, N, 2 * F, generator=gen,
                         device="cuda").bfloat16()
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    before = KERNEL_LAUNCHES["step_attend_reorder"]
    a, da = step_attend_reorder(q, kv_new, kvg, cache, torch.zeros_like(cache),
                                src, 1, t, bias_hist, bias_new, H,
                                write_back=write_back)
    b, db = step_attend_reorder_plain(q, kv_new, kvg, cache,
                                      torch.zeros_like(cache), src, 1, t,
                                      bias_hist, bias_new, H,
                                      write_back=write_back)
    torch.cuda.synchronize()
    assert torch.equal(da, db)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    assert KERNEL_LAUNCHES["step_attend_reorder"] == before + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [0, 5, Mc - 1])
def test_non_deferred_kernels_match_plain(dtype, t, gen):
    cache = torch.randn(L, 2, B, N, Mc, F, generator=gen, device="cuda",
                        dtype=dtype)
    q, k_new, v_new = (torch.randn(B, N, F, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    before = dict(KERNEL_LAUNCHES)
    args = (q, k_new, v_new, cache, 2, bias_hist, bias_new, H)
    a, b = step_attention_fused(*args), step_attention_fused_plain(*args)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    G = L * 2 * B
    flat = cache.view(G, N, Mc, F)
    src = torch.randint(0, N, (G, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    kvg = flat[:, :, 0].contiguous()
    got = beam_gather_update(flat, kvg, src, t, torch.empty_like(flat))
    want = beam_gather_update_plain(flat, kvg, src, t, torch.empty_like(flat))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert KERNEL_LAUNCHES["step_attention_fused"] == (
        before["step_attention_fused"] + 1)
    assert KERNEL_LAUNCHES["beam_gather_update"] == (
        before["beam_gather_update"] + 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [0, 5, Mc - 1])
def test_write_attend_kernels_match_plain(dtype, t, gen):
    """K8 over layer 1's K and V planes (slots > t masked; bf16 within
    2e-2, f32 within 1e-4) and K7 over the L*2*B planes (bit-equal)."""
    cache = torch.randn(L, 2, B, N, Mc, F, generator=gen, device="cuda",
                        dtype=dtype)
    q = torch.randn(B, N, F, generator=gen, device="cuda", dtype=dtype)
    bias = torch.randn(Mc, H, generator=gen, device="cuda")
    bias[t + 1:] = -1e30
    before = dict(KERNEL_LAUNCHES)
    args = (q, cache[1, 0], cache[1, 1], bias, H)
    a, b = step_attention(*args), step_attention_plain(*args)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    G = L * 2 * B
    flat = cache.view(G, N, Mc, F)
    src = torch.randint(0, N, (G, N), generator=gen, device="cuda",
                        dtype=torch.int32)
    out = torch.empty_like(flat)
    assert beam_gather_blocks(flat, src, out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, beam_gather_blocks_plain(flat, src))
    assert KERNEL_LAUNCHES["step_attention"] == before["step_attention"] + 1
    assert KERNEL_LAUNCHES["beam_gather_blocks"] == (
        before["beam_gather_blocks"] + 1)


@pytest.mark.parametrize("dtype,R,C,offset", [
    (torch.int8, 4, 32, 0),        # 128-byte blocks: 16-byte vectors
    (torch.bfloat16, 3, 12, 0),    # 72 bytes: 8-byte vectors
    (torch.float32, 1, 3, 0),      # 12 bytes: 4-byte vectors
    (torch.bfloat16, 1, 3, 0),     # 6 bytes: 2-byte vectors
    (torch.int8, 5, 13, 0),        # 65 bytes: 1-byte copies
    (torch.int8, 4, 32, 1),        # odd base address: 1-byte copies
])
def test_beam_gather_blocks_narrow(dtype, R, C, offset, gen):
    """Blocks whose bytes or base address rule out 16-byte vectors stay in
    the kernel with narrower ones."""
    G, n = 6, 37
    flat = torch.randint(-100, 100, (G * n * R * C + offset,), generator=gen,
                         device="cuda").to(dtype)
    cache = flat[offset:].view(G, n, R, C)
    src = torch.randint(0, n, (G, n), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = KERNEL_LAUNCHES["beam_gather_blocks"]
    got = beam_gather_blocks(cache, src)
    torch.cuda.synchronize()
    assert torch.equal(got, beam_gather_blocks_plain(cache, src))
    assert KERNEL_LAUNCHES["beam_gather_blocks"] == before + 1


# ---------------------------------------------------------------------------
# K2 and K4 on the staged core (csrc/attend_staged.cuh): edges of the grid
# (B*N = 1, below the grid, not a multiple of it), Mc from 1 to 32, D of 16
# and 64 (the vector path) and 24 (the scalar path), f32 at t5-base width
# in a single stage, K4's modes, and the packed products bit for bit.
# ---------------------------------------------------------------------------

def _rows(quant, lead, F, H, gen, dtype=torch.bfloat16):
    kv = torch.randn(*lead, 2 * F, generator=gen, device="cuda")
    if quant == "int8":
        return quantize_rows_plain(kv, H)
    if quant == "int4":
        return quantize_rows_int4_plain(kv, H)
    return kv.to(dtype)


def _attn_inputs(Bq, Nq, F, H, Mc, t, gen, dtype=torch.bfloat16):
    q = torch.randn(Bq, Nq, F, generator=gen, device="cuda").to(dtype)
    kv_new = torch.randn(Bq, Nq, 2 * F, generator=gen, device="cuda").to(dtype)
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    return q, kv_new, bias_hist, bias_new


STAGED_SHAPES = [           # (B, N, Mc, H, D)
    (1, 1, 8, 12, 64),      # B*N = 1
    (2, 40, 1, 12, 64),     # Mc = 1, below the grid
    (3, 1000, 24, 12, 64),  # not a multiple of the grid
    (8, 1000, 32, 12, 64),  # the main path's shape
    (2, 24, 8, 4, 16),      # ripor_small's D
    (3, 50, 32, 4, 16),
    (2, 30, 8, 2, 24),      # D = 24: the scalar path
    (2, 30, 8, 2, 20),      # F = 40: rows of no 16-byte multiple, so the
                            # producer warp copies without bulk copies
]


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D", STAGED_SHAPES)
def test_staged_seq_shapes(Bq, Nq, Mc, H, D, quant, gen):
    F, L = H * D, 2
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
    t = max(Mc - 1, 1)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, t, gen)
    args = (q, kv_new, cache, 1, bias_hist, bias_new, H, quant)
    before = KERNEL_LAUNCHES["step_attention_seq"]
    a, b = step_attention_seq(*args), step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    if quant:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    assert KERNEL_LAUNCHES["step_attention_seq"] == before + 1


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_staged_unaligned_inputs(quant, gen):
    """q and kv_new 2 bytes off a 16-byte boundary (contiguous views of
    a larger buffer): no bulk copies, the same results."""
    Bq, Nq, Mc, H, D = 2, 100, 8, 12, 64
    F = H * D
    cache = _rows(quant, (Bq, Nq, 2, Mc), F, H, gen)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, 5, gen)
    buf = torch.empty(1 + q.numel() + kv_new.numel(), device="cuda",
                      dtype=q.dtype)
    qu = buf[1:1 + q.numel()].view_as(q)
    kvu = buf[1 + q.numel():].view_as(kv_new)
    qu.copy_(q)
    kvu.copy_(kv_new)
    assert qu.data_ptr() % 16 != 0
    a = step_attention_seq(qu, kvu, cache, 1, bias_hist, bias_new, H, quant)
    b = step_attention_seq_plain(q, kv_new, cache, 1, bias_hist, bias_new, H,
                                 quant)
    torch.cuda.synchronize()
    if quant:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("quant", [None, "int4"])
def test_staged_seq_f32_single_stage(quant, gen):
    """f32 q (and f32 exact rows) at t5-base width, Mc = 32: the exact
    cache takes one stage; f32 math within 1e-4, quantized rows within
    2e-2."""
    from ripor_tpu_torch.ops.staging import stage_plan
    Bq, Nq, Mc, H, D = 2, 300, 32, 12, 64
    F = H * D
    cache = _rows(quant, (Bq, Nq, 2, Mc), F, H, gen, dtype=torch.float32)
    if quant is None:
        assert stage_plan(None, 4, 4, Mc, F, H).stages == 1
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, Mc - 3,
                                                  gen, dtype=torch.float32)
    args = (q, kv_new, cache, 0, bias_hist, bias_new, H, quant)
    a, b = step_attention_seq(*args), step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    if quant:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    tol = 1e-4 if quant is None else 2e-2
    torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("src_kind", ["random", "repeated", "identity"])
@pytest.mark.parametrize("t,write_back", [(0, True), (1, True), (7, False),
                                          (7, True)])
@pytest.mark.parametrize("quant,kvg_q8", [(None, False), ("int8", False),
                                          ("int8", True), ("int4", False)])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D", [(1, 1, 8, 12, 64),
                                          (3, 333, 8, 12, 64),
                                          (2, 24, 8, 4, 16),
                                          (2, 30, 8, 2, 24),
                                          (2, 30, 8, 2, 20)])
def test_staged_attend_reorder_modes(Bq, Nq, Mc, H, D, quant, kvg_q8, t,
                                     write_back, src_kind, gen):
    F, L = H * D, 2
    cache = _rows(quant, (L, Bq, Nq, Mc), F, H, gen)
    if src_kind == "identity":
        src = torch.arange(Nq, device="cuda", dtype=torch.int32).repeat(Bq, 1)
    elif src_kind == "repeated":
        src = torch.randint(0, 2, (Bq, Nq), generator=gen, device="cuda",
                            dtype=torch.int32)
    else:
        src = torch.randint(0, Nq, (Bq, Nq), generator=gen, device="cuda",
                            dtype=torch.int32)
    kvg = torch.randn(Bq, Nq, L, 2 * F, generator=gen, device="cuda")
    kvg = (quantize_rows_plain(kvg, H) if kvg_q8
           else kvg.bfloat16()).reshape(Bq, Nq, -1)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, t, gen)
    before = KERNEL_LAUNCHES["step_attend_reorder"]
    a, da = step_attend_reorder(q, kv_new, kvg, cache,
                                torch.zeros_like(cache), src, 1, t,
                                bias_hist, bias_new, H, write_back=write_back)
    b, db = step_attend_reorder_plain(q, kv_new, kvg, cache,
                                      torch.zeros_like(cache), src, 1, t,
                                      bias_hist, bias_new, H,
                                      write_back=write_back)
    torch.cuda.synchronize()
    assert torch.equal(da, db)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    assert KERNEL_LAUNCHES["step_attend_reorder"] == before + 1


@pytest.mark.parametrize("Mc", [1, 24, 32])
@pytest.mark.parametrize("quant,kvg_q8", [("int4", False), ("int8", True),
                                          (None, False)])
def test_staged_attend_reorder_segments(Mc, quant, kvg_q8, gen):
    """K4 at the segment sizes at t5-base width, slot t-1 = Mc-1."""
    Bq, Nq, H, D, L = 2, 200, 12, 64, 2
    F = H * D
    cache = _rows(quant, (L, Bq, Nq, Mc), F, H, gen)
    src = torch.randint(0, Nq, (Bq, Nq), generator=gen, device="cuda",
                        dtype=torch.int32)
    kvg = torch.randn(Bq, Nq, L, 2 * F, generator=gen, device="cuda")
    kvg = (quantize_rows_plain(kvg, H) if kvg_q8
           else kvg.bfloat16()).reshape(Bq, Nq, -1)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, Mc, gen)
    a, da = step_attend_reorder(q, kv_new, kvg, cache, torch.zeros_like(cache),
                                src, 0, Mc, bias_hist, bias_new, H)
    b, db = step_attend_reorder_plain(q, kv_new, kvg, cache,
                                      torch.zeros_like(cache), src, 0, Mc,
                                      bias_hist, bias_new, H)
    torch.cuda.synchronize()
    assert torch.equal(da, db)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e-38, 1e30, 3e38])
def test_staged_packed_products_bitwise(quant, scale, gen):
    """The kernels' packed bf16x2 products (k*q and p*v) against the plain
    version's products (formed in f32, rounded to bf16), bit for bit, on q
    and p near the ends of bf16's range."""
    from ripor_tpu_torch.ops._build import kernel_fn
    from ripor_tpu_torch.ops.attend_reorder import KIND_CODE, decode_rows
    R, H, D = 64, 12, 64
    F = H * D
    rows = _rows(quant, (R,), F, H, gen)
    if quant is None:
        rows = (rows.float() * scale ** 0.5).bfloat16()
    q = (torch.randn(F, generator=gen, device="cuda") * scale).bfloat16()
    pe = (torch.rand(R, generator=gen, device="cuda") * scale).bfloat16()
    k, v, _, _ = decode_rows(rows, F, H, quant)
    want_kq, want_pv = k * q, pe[:, None] * v
    got_kq = torch.empty(R, F, device="cuda", dtype=torch.bfloat16)
    got_pv = torch.empty_like(got_kq)
    fn = kernel_fn("step_attention_seq", "staged_products", 5, 4)
    rc = fn(q.data_ptr(), rows.data_ptr(), pe.data_ptr(), got_kq.data_ptr(),
            got_pv.data_ptr(), R, F, rows.shape[-1], KIND_CODE[quant],
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    assert torch.equal(got_kq.view(torch.int16), want_kq.view(torch.int16))
    assert torch.equal(got_pv.view(torch.int16), want_pv.view(torch.int16))


# ---------------------------------------------------------------------------
# K5 and K8 on the staged core (attend_planes: two bulk copies of a beam's K
# and V planes): the same edges, D of 128 (t5-3b) too, f32 in one stage,
# t = 0, misaligned q; slabs larger than one stage (slot chunks) for all
# four staged kernels; and exact products where bf16-rounded ones would
# move the output.
# ---------------------------------------------------------------------------

PLANE_SHAPES = STAGED_SHAPES + [(2, 50, 16, 4, 128),   # t5-3b's D
                                (8, 1000, 8, 32, 128)]


def _plane_inputs(Bq, Nq, Mc, H, D, gen, dtype, L=2):
    F = H * D
    cache = torch.randn(L, 2, Bq, Nq, Mc, F, generator=gen, device="cuda",
                        dtype=dtype)
    q, k_new, v_new = (torch.randn(Bq, Nq, F, generator=gen, device="cuda",
                                   dtype=dtype) for _ in range(3))
    return cache, q, k_new, v_new


def _fused_args(cache, q, k_new, v_new, t, H, gen, layer=1):
    Mc = cache.shape[4]
    bias_hist = torch.randn(Mc, H, generator=gen, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=gen, device="cuda")
    return (q, k_new, v_new, cache, layer, bias_hist, bias_new, H)


def _step_args(cache, q, t, H, gen, layer=1):
    Mc = cache.shape[4]
    bias = torch.randn(Mc, H, generator=gen, device="cuda")
    bias[t + 1:] = -1e30
    return (q, cache[layer, 0], cache[layer, 1], bias, H)


def _run_both(kernel, args):
    name = "step_attention_fused" if kernel == "K5" else "step_attention"
    fn, plain = ((step_attention_fused, step_attention_fused_plain)
                 if kernel == "K5" else (step_attention, step_attention_plain))
    before = KERNEL_LAUNCHES[name]
    a, b = fn(*args), plain(*args)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES[name] == before + 1
    return a, b


@pytest.mark.parametrize("kernel", ["K5", "K8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D", PLANE_SHAPES)
def test_staged_planes_shapes(Bq, Nq, Mc, H, D, dtype, kernel, gen):
    cache, q, k_new, v_new = _plane_inputs(Bq, Nq, Mc, H, D, gen, dtype)
    t = max(Mc - 1, 1) if kernel == "K5" else Mc - 1
    args = (_fused_args(cache, q, k_new, v_new, t, H, gen) if kernel == "K5"
            else _step_args(cache, q, t, H, gen))
    a, b = _run_both(kernel, args)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["K5", "K8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", [0, 1, 16, 31])
def test_staged_planes_steps(t, dtype, kernel, gen):
    """t5-base width, Mc = 32 (f32: one stage), at t = 0 (K5: position t
    alone; K8: slot 0 alone) and later steps."""
    from ripor_tpu_torch.ops.staging import stage_plan
    Bq, Nq, Mc, H, D = 2, 300, 32, 12, 64
    esz = 4 if dtype == torch.float32 else 2
    plan = stage_plan(None, esz, esz, Mc, H * D, H, planes=True,
                      new=kernel == "K5")
    assert plan.chunks == 1 and plan.stages == (1 if esz == 4 else 2)
    cache, q, k_new, v_new = _plane_inputs(Bq, Nq, Mc, H, D, gen, dtype)
    args = (_fused_args(cache, q, k_new, v_new, t, H, gen) if kernel == "K5"
            else _step_args(cache, q, t, H, gen))
    a, b = _run_both(kernel, args)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["K5", "K8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_staged_planes_unaligned_q(kernel, dtype, gen):
    """q (and K5's k_new, v_new) off a 16-byte boundary: plain copies, the
    same results."""
    Bq, Nq, Mc, H, D = 2, 100, 8, 12, 64
    cache, q, k_new, v_new = _plane_inputs(Bq, Nq, Mc, H, D, gen, dtype)
    buf = torch.empty(1 + 3 * q.numel(), device="cuda", dtype=dtype)
    views = [buf[1 + i * q.numel():1 + (i + 1) * q.numel()].view_as(q)
             for i in range(3)]
    for v, x in zip(views, (q, k_new, v_new)):
        v.copy_(x)
    assert views[0].data_ptr() % 16 != 0
    if kernel == "K5":
        args = _fused_args(cache, *views, 5, H, gen)
        want = step_attention_fused_plain(q, k_new, v_new, *args[3:])
        got = step_attention_fused(*args)
    else:
        args = _step_args(cache, views[0], 5, H, gen)
        want = step_attention_plain(q, *args[1:])
        got = step_attention(*args)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# oversized slabs on a small lead: (kernel, rows, F, H, Mc); t5-3b is
# F = 4096, H = 32; t5-large F = 1024, H = 16; the last cases take the
# scalar path (D = 20, 24) and, for int4 rows of 168 bytes, plain copies
OVERSIZED = [
    ("K2", "bf16", 4096, 32, 32), ("K2", "int8", 4096, 32, 32),
    ("K2", "f32", 1024, 16, 32), ("K2", "int4", 40, 2, 1400),
    ("K2", "f32", 48, 2, 640),
    ("K5", "f32", 1024, 16, 32), ("K5", "bf16", 4096, 32, 32),
    ("K8", "f32", 1024, 16, 32), ("K8", "bf16", 4096, 32, 32),
    ("K8", "bf16", 40, 2, 1600),
]


def _chunked_plan(kernel, rows, F, H, Mc, exact_kvg=False):
    from ripor_tpu_torch.ops.staging import stage_plan
    quant = rows if rows in ("int8", "int4") else None
    esz = {"f32": 4, "bf16": 2}.get(rows, 1)
    qesz = 4 if rows == "f32" else 2
    plan = stage_plan(quant, esz, qesz, Mc, F, H, exact_kvg=exact_kvg,
                      planes=kernel in ("K5", "K8"), new=kernel != "K8")
    assert plan.chunks > 1
    return plan


@pytest.mark.parametrize("kernel,rows,F,H,Mc", OVERSIZED)
def test_staged_oversized_chunks(kernel, rows, F, H, Mc, gen):
    """Slabs no stage can hold stream through the ring in slot chunks, two
    passes (scores, then V sums), and agree with the plain versions."""
    _chunked_plan(kernel, rows, F, H, Mc)
    Bq, Nq = 2, 50
    dtype = torch.float32 if rows == "f32" else torch.bfloat16
    tol = 1e-4 if rows == "f32" else 2e-2
    if kernel == "K2":
        quant = rows if rows in ("int8", "int4") else None
        cache = _rows(quant, (Bq, Nq, 1, Mc), F, H, gen, dtype=dtype)
        q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc,
                                                      Mc - 3, gen, dtype)
        args = (q, kv_new, cache, 0, bias_hist, bias_new, H, quant)
        before = KERNEL_LAUNCHES["step_attention_seq"]
        a, b = step_attention_seq(*args), step_attention_seq_plain(*args)
        torch.cuda.synchronize()
        assert KERNEL_LAUNCHES["step_attention_seq"] == before + 1
        if quant:
            (a, aq), (b, bq) = a, b
            assert torch.equal(aq, bq)
            tol = 2e-2
    else:
        D = F // H
        cache, q, k_new, v_new = _plane_inputs(Bq, Nq, Mc, H, D, gen, dtype,
                                               L=1)
        t = Mc - 3
        args = (_fused_args(cache, q, k_new, v_new, t, H, gen, layer=0)
                if kernel == "K5" else _step_args(cache, q, t, H, gen,
                                                  layer=0))
        a, b = _run_both(kernel, args)
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("write_back", [True, False])
@pytest.mark.parametrize("slot", ["first", "chunk end", "chunk start",
                                  "last"])
@pytest.mark.parametrize("rows,kvg_q8,F,H", [
    ("bf16", False, 4096, 32),     # verbatim insert of exact rows
    ("int8", True, 4096, 32),      # verbatim insert of int8 kvg rows
    ("int8", False, 4096, 32),     # in-kernel quantize of slot t-1
    ("int4", False, 4096, 32),
    ("f32", False, 1024, 16),
])
def test_staged_attend_reorder_oversized(rows, kvg_q8, F, H, slot,
                                         write_back, gen):
    """K4 in slot chunks: every chunk of the score pass is stored once,
    slot t-1's insert lands in the chunk that holds it (at a chunk's
    first or last slot too), the V pass stores nothing."""
    Bq, Nq, Mc, L = 2, 40, 32, 2
    quant = rows if rows in ("int8", "int4") else None
    plan = _chunked_plan("K4", rows, F, H, Mc,
                         exact_kvg=quant is not None and not kvg_q8)
    cs = plan.chunk_slots
    t = {"first": 1, "chunk end": cs, "chunk start": cs + 1,
         "last": Mc}[slot]
    dtype = torch.float32 if rows == "f32" else torch.bfloat16
    cache = _rows(quant, (L, Bq, Nq, Mc), F, H, gen, dtype=dtype)
    src = torch.randint(0, Nq, (Bq, Nq), generator=gen, device="cuda",
                        dtype=torch.int32)
    kvg = torch.randn(Bq, Nq, L, 2 * F, generator=gen, device="cuda")
    kvg = (quantize_rows_plain(kvg, H) if kvg_q8
           else kvg.to(dtype)).reshape(Bq, Nq, -1)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, t, gen,
                                                  dtype)
    before = KERNEL_LAUNCHES["step_attend_reorder"]
    a, da = step_attend_reorder(q, kv_new, kvg, cache, torch.zeros_like(cache),
                                src, 1, t, bias_hist, bias_new, H,
                                write_back=write_back)
    b, db = step_attend_reorder_plain(q, kv_new, kvg, cache,
                                      torch.zeros_like(cache), src, 1, t,
                                      bias_hist, bias_new, H,
                                      write_back=write_back)
    torch.cuda.synchronize()
    assert KERNEL_LAUNCHES["step_attend_reorder"] == before + 1
    assert torch.equal(da, db)
    tol = 1e-4 if rows == "f32" else 2e-2
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("kernel", ["K5", "K8"])
def test_staged_planes_keep_exact_products(kernel, gen):
    """K5 and K8 form k*q as exact f32 products of bf16 values, as their
    references do. Here every k and q entry is (1 + 2^-7) times a power of
    two: the exact product is (1 + 2^-6 + 2^-14) 2^e, a bf16-rounded one
    (1 + 2^-6) 2^e. The biases cancel the rounded scores, so exact
    products leave scores of 1 to 16 and rounded ones scores of 0: the
    outputs differ by far more than the bar, and the kernels agree with
    their plain versions."""
    Bq, Nq, Mc, H, D = 1, 64, 8, 2, 64
    F = H * D
    one = 1.0 + 2.0 ** -7
    e = torch.tensor([8.0 + m % 5 for m in range(Mc)], device="cuda")
    k = (one * 2.0 ** e)[:, None].expand(Mc, F)
    cache_k = k.expand(Bq, Nq, Mc, F).bfloat16().contiguous()
    cache_v = torch.randn(Bq, Nq, Mc, F, generator=gen, device="cuda",
                          dtype=torch.bfloat16)
    q = torch.full((Bq, Nq, F), one, device="cuda", dtype=torch.bfloat16)
    rounded = D * (1.0 + 2.0 ** -6) * 2.0 ** e          # exact in f32
    bias = (-rounded)[:, None].expand(Mc, H).contiguous()
    kq_rounded = (cache_k.float() * q.float()[:, :, None]).bfloat16()
    if kernel == "K5":
        cache = torch.stack([cache_k, cache_v])[None].contiguous()
        k_new = torch.zeros_like(q)
        v_new = torch.randn(Bq, Nq, F, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        bias_new = torch.zeros(1, H, device="cuda")
        args = (q, k_new, v_new, cache, 0, bias, bias_new, H)
        from ripor_tpu_torch.ops.attend_reorder import attend_plain
        off = attend_plain(q, k_new, v_new, cache_k, cache_v, bias, bias_new,
                           H, torch.bfloat16)
    else:
        args = (q, cache_k, cache_v, bias, H)
        scores = kq_rounded.float().reshape(Bq, Nq, Mc, H, D).sum(-1) + bias
        probs = torch.softmax(scores, dim=2).bfloat16().float()
        off = (probs.repeat_interleave(D, dim=-1) * cache_v.float()).sum(2)
    a, b = _run_both(kernel, args)
    assert (off.float() - b.float()).abs().max().item() > 0.25
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# K1' (quantize on insert), K1'' (the fused kvg gather) and K2' (exact p*v
# products), each with its own launch counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("quant,kvg_rows", [
    ("int8", "bf16"), ("int4", "bf16"), ("int8", "f32"), ("int4", "f32"),
    ("int8", "cache"), ("int4", "cache"), (None, "cache")])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D", [(2, 40, 8, 12, 64),
                                          (2, 30, 8, 2, 20)])
def test_reorder_bodies_match_plain(Bq, Nq, Mc, H, D, quant, kvg_rows, t,
                                    fused, gen):
    """Every body of K1 bit-equal to its plain version: exact bf16/f32 kvg
    rows quantized on insert (K1'), cache-layout rows inserted verbatim,
    each read in order or through src (K1''); D = 20 gives rows of no
    16-byte multiple (int4: 168 bytes), so the byte loop runs."""
    from ripor_tpu_torch.ops.megarow import reorder_body
    F, L = H * D, 3
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
    src = torch.randint(0, Nq, (Bq, Nq), generator=gen, device="cuda",
                        dtype=torch.int32)
    kv = torch.randn(Bq, Nq, L, 2 * F, generator=gen, device="cuda") * 3
    if kvg_rows == "cache":
        kvg = _rows(quant, (Bq, Nq, L), F, H, gen)
        insert = None
    else:
        kvg = kv.to(torch.float32 if kvg_rows == "f32" else torch.bfloat16)
        insert = quant
    kvg = kvg.reshape(Bq, Nq, -1).contiguous()
    name = reorder_body(insert is not None, fused)
    before = dict(KERNEL_LAUNCHES)
    got = reorder_cache_all(kvg, cache, torch.empty_like(cache), src, t, H,
                            fused_kvg=fused)
    want = reorder_cache_all_plain(kvg, cache, torch.empty_like(cache), src,
                                   t, H, fused_kvg=fused)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert KERNEL_LAUNCHES[name] == before[name] + 1
    assert sum(KERNEL_LAUNCHES.values()) == sum(before.values()) + 1


def test_quantize_on_insert_equals_qfuse_rows(gen):
    """K1' inserts the bytes K2's QFUSE rows carry: the same codec on the
    same values, so quantize-then-gather and gather-then-quantize agree."""
    Bq, Nq, Mc, L = 2, 40, 8, 3
    for quant in ("int8", "int4"):
        cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
        src = torch.randint(0, Nq, (Bq, Nq), generator=gen, device="cuda",
                            dtype=torch.int32)
        kv = torch.randn(Bq, Nq, L, 2 * F, generator=gen,
                         device="cuda").bfloat16()
        qrows = (quantize_rows_plain if quant == "int8"
                 else quantize_rows_int4_plain)(kv, H)
        a = reorder_cache_all(kv.reshape(Bq, Nq, -1), cache,
                              torch.empty_like(cache), src, 6, H,
                              fused_kvg=True)
        b = reorder_cache_all(qrows.reshape(Bq, Nq, -1), cache,
                              torch.empty_like(cache), src, 6,
                              fused_kvg=True)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("emit", [False, True])
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("Bq,Nq,Mc,H,D,dtype", [
    *[(*shape, torch.bfloat16) for shape in STAGED_SHAPES],
    (2, 300, 32, 12, 64, torch.float32),     # f32 q, t5-base width
    (2, 50, 32, 32, 128, torch.bfloat16),    # t5-3b: int8 slot chunks
])
def test_staged_seq_mxu_math(Bq, Nq, Mc, H, D, dtype, quant, emit, gen):
    """K2' (mxu_math on int8/int4 rows) against its plain version at the
    staged kernels' bar, its QFUSE rows bit-equal, counted apart from
    K2."""
    F, L = H * D, 2
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
    t = max(Mc - 1, 1)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, t, gen,
                                                  dtype)
    args = (q, kv_new, cache, 1, bias_hist, bias_new, H,
            quant if emit else None)
    before = dict(KERNEL_LAUNCHES)
    a = step_attention_seq(*args, mxu_math=True)
    b = step_attention_seq_plain(*args, mxu_math=True)
    torch.cuda.synchronize()
    if emit:
        (a, aq), (b, bq) = a, b
        assert torch.equal(aq, bq)
    torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
    assert KERNEL_LAUNCHES["step_attention_seq_mxu"] == \
        before["step_attention_seq_mxu"] + 1
    assert KERNEL_LAUNCHES["step_attention_seq"] == \
        before["step_attention_seq"]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_mxu_math_keeps_exact_value_products(quant, gen):
    """K2' forms each p*v product exactly: in f32 (q, kv_new and the
    output), the kernel stays within sum-order noise of the exact-product
    plain version, ten times closer than the default's rounded products
    are."""
    Bq, Nq, Mc, L = 2, 200, 32, 1
    cache = _rows(quant, (Bq, Nq, L, Mc), F, H, gen)
    q, kv_new, bias_hist, bias_new = _attn_inputs(Bq, Nq, F, H, Mc, Mc - 1,
                                                  gen, torch.float32)
    args = (q, kv_new, cache, 0, bias_hist, bias_new, H)
    a = step_attention_seq(*args, mxu_math=True)
    b = step_attention_seq_plain(*args, mxu_math=True)
    c = step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    err = (a - b).abs().max().item()
    gap = (c - b).abs().max().item()
    assert err * 10 < gap, (err, gap)


def test_cli_retrieve_on_card_equals_engine(gen, tmp_path):
    """The port's `retrieve` CLI on the card (a toy workspace the port
    writes) gives the run RetrievalEngine gives on the card: same docids
    in the same order, same scores."""
    import json

    import numpy as np

    from ripor_tpu_torch.cli.main import main as cli
    from ripor_tpu_torch.data.datasets import save_docid_to_smtid
    from ripor_tpu_torch.data.tokenizer import WordTokenizer
    from ripor_tpu_torch.models import init_params, ripor_small
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.train import save_params
    from ripor_tpu_torch.trie import build_trie

    cfg = ripor_small(M=8, K=16)
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ws = tmp_path / "ws"
    save_params(ws / "checkpoints/final", sd, cfg)
    words = [f"w{i}" for i in range(200)]
    WordTokenizer.train(words).save(ws / "tokenizer.json")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (300, 8))
    docids = [f"d{i}" for i in range(300)]
    save_docid_to_smtid(ws / "docid_to_smtid.json", docids, codes)
    texts = [" ".join(rng.choice(words, 4)) for _ in range(11)]
    (tmp_path / "raw.tsv").write_text(
        "".join(f"q{i}\t{t}\n" for i, t in enumerate(texts)))
    before = dict(KERNEL_LAUNCHES)
    cli(["retrieve", "--workspace", str(ws), "--queries", str(tmp_path),
         "--beam", "16", "--topk", "20"])
    assert all(KERNEL_LAUNCHES[k] > before[k] for k in (
        "reorder_cache_all", "step_attention_seq", "beam_gather_rows"))
    run = json.loads((ws / "run.json").read_text())
    eng = RetrievalEngine(cfg, sd, WordTokenizer.load(ws / "tokenizer.json"),
                          build_trie(codes, 16), docids,
                          ServeConfig(num_beams=16, topk=20,
                                      batch_sizes=(8,)), device="cuda")
    want = eng.retrieve_batch(texts)
    assert list(run) == [f"q{i}" for i in range(11)]
    for qid, res in zip(run, want):
        assert len(res) == 16
        assert list(run[qid].items()) == res
