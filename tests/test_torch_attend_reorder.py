"""Plain version of the port's K4 (step_attend_reorder) against the JAX
package's Pallas kernel in interpret mode. The CUDA kernel itself is held
against this plain version on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py).

cache_dst is integer data movement plus the row codec: bit-equal. The
attention of an exact f32 cache sums in another order: 1e-5. Quantized
caches round products to bf16 at the reference's points, and the sum order
moves one of those roundings now and then: 1e-3. XLA's CPU backend skips
intermediate bf16 roundings by default (xla_allow_excess_precision), which
moves the reference off its own written math, so it is compiled without
them. Inputs keep every exponent inside |e| <= 12, where XLA's CPU exp2
is exact (ROADMAP.md Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.ops.attend_reorder import (quantize_rows_xla,
                                          quantize_rows_xla_int4)
from ripor_tpu.ops.attend_reorder import step_attend_reorder as jax_sar
from ripor_tpu_torch.ops import KERNEL_LAUNCHES
from ripor_tpu_torch.ops.attend_reorder import step_attend_reorder

B, N, L, H, D, Mc = 2, 8, 3, 4, 16, 8
F = H * D
LAYER = 1
QFN = {"int8": quantize_rows_xla, "int4": quantize_rows_xla_int4}


def _inputs(seed, quant, kvg_q8, t):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((L, B, N, Mc, 2 * F)).astype(np.float32)
    cache = (rows if quant is None
             else np.array(QFN[quant](jnp.asarray(rows), H)))
    kvg = (rng.standard_normal((B, N, L, 2 * F)) * 2).astype(np.float32)
    if kvg_q8:
        kvg = np.array(quantize_rows_xla(jnp.asarray(kvg), H))
    kvg = kvg.reshape(B, N, -1)
    src = rng.integers(0, N, (B, N)).astype(np.int32)
    q = rng.standard_normal((B, N, F)).astype(np.float32)
    kv_new = (rng.standard_normal((B, N, 2 * F)) * 2).astype(np.float32)
    bias_hist = rng.standard_normal((Mc, H)).astype(np.float32)
    bias_hist[t:] = -1e30                     # slots >= t masked
    bias_new = rng.standard_normal((1, H)).astype(np.float32)
    return q, kv_new, kvg, cache, src, bias_hist, bias_new


def _compare(quant, kvg_q8, t, write_back, tol):
    q, kv_new, kvg, cache, src, bh, bn = _inputs(t + 3, quant, kvg_q8, t)
    ref = jax.jit(
        lambda q_, kv_, g_, c_, s_, bh_, bn_: jax_sar(
            q_, kv_, g_, c_, jnp.zeros_like(c_), s_, LAYER, t, bh_, bn_, H,
            write_back=write_back, interpret=True, chunk=N),
        compiler_options={"xla_allow_excess_precision": False})
    want, want_dst = ref(*map(jnp.asarray,
                              (q, kv_new, kvg, cache, src, bh, bn)))
    dst = torch.zeros(cache.shape, dtype=torch.from_numpy(cache).dtype)
    got, got_dst = step_attend_reorder(
        *map(torch.from_numpy, (q, kv_new, kvg, cache)), dst,
        torch.from_numpy(src), LAYER, t, torch.from_numpy(bh),
        torch.from_numpy(bn), H, write_back=write_back)
    assert got_dst is dst
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    if write_back:
        np.testing.assert_array_equal(got_dst.numpy(), np.asarray(want_dst))
    else:
        # the final step writes nothing
        assert not got_dst.any()


@pytest.mark.parametrize("t,write_back", [(0, True), (5, True),
                                          (5, False)])
def test_f32_cache(t, write_back):
    _compare(None, False, t, write_back, 1e-5)


@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("quant,kvg_q8", [("int8", False), ("int8", True),
                                          ("int4", False)])
def test_quantized_cache(quant, kvg_q8, t):
    """int8 with exact kvg rows quantized at insert and read exactly at
    slot t-1; int8 with pre-quantized kvg rows inserted verbatim; int4."""
    _compare(quant, kvg_q8, t, True, 1e-3)


def test_quantized_final_step_writes_nothing():
    _compare("int4", False, 5, False, 1e-3)


def test_refuses_int8_kvg_on_int4_cache():
    q, kv_new, kvg, cache, src, bh, bn = _inputs(0, "int4", True, 3)
    c = torch.from_numpy(cache)
    with pytest.raises(ValueError, match="int8 kvg"):
        step_attend_reorder(*map(torch.from_numpy, (q, kv_new, kvg)), c,
                            torch.zeros_like(c), torch.from_numpy(src), 0, 3,
                            torch.from_numpy(bh), torch.from_numpy(bn), H)


def test_cpu_tensors_launch_no_kernel():
    before = dict(KERNEL_LAUNCHES)
    q, kv_new, kvg, cache, src, bh, bn = _inputs(0, "int8", False, 3)
    c = torch.from_numpy(cache)
    step_attend_reorder(*map(torch.from_numpy, (q, kv_new, kvg)), c,
                        torch.zeros_like(c), torch.from_numpy(src), 0, 3,
                        torch.from_numpy(bh), torch.from_numpy(bn), H)
    assert KERNEL_LAUNCHES == before
