"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a CUDA device every test here skips. On the
card: ``python -m pytest tests/test_torch_kernels_cuda.py -q`` (the main-path
shapes are checked by chip_smoke.py)."""
import pytest
import torch

from ripor_tpu_torch.ops import (KERNEL_LAUNCHES, beam_gather_rows,
                                 beam_gather_rows_plain,
                                 quantize_rows_int4_plain,
                                 quantize_rows_plain, reorder_cache_all,
                                 reorder_cache_all_plain, step_attention_seq,
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
    assert all(KERNEL_LAUNCHES[k] == before[k] + 1 for k in before)
