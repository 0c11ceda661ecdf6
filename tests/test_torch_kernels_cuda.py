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
