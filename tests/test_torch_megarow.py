"""Plain versions of the port's megarow kernels (K1 reorder_cache_all, K2
step_attention_seq, K3 beam_gather_rows) against the JAX package's Pallas
kernels in interpret mode. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.ops.attend_reorder import (quantize_rows_xla,
                                          quantize_rows_xla_int4)
from ripor_tpu.ops.beam_gather import beam_gather_rows as jax_gather
from ripor_tpu.ops.megarow import reorder_cache_all as jax_reorder
from ripor_tpu.ops.megarow import step_attention_seq as jax_seq
from ripor_tpu_torch.ops import KERNEL_LAUNCHES
from ripor_tpu_torch.ops.beam_gather import beam_gather_rows
from ripor_tpu_torch.ops.megarow import reorder_cache_all, step_attention_seq

B, N, L, H, D, Mc = 2, 8, 3, 4, 16, 8
F = H * D
RW = {None: 2 * F, "int8": 2 * F + 128, "int4": F + 128}
QFN = {"int8": quantize_rows_xla, "int4": quantize_rows_xla_int4}


def _cache(rng, quant):
    kv = rng.standard_normal((B, N, L, Mc, 2 * F)).astype(np.float32)
    if quant is None:
        return kv
    return np.array(QFN[quant](jnp.asarray(kv), H))


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("t", [0, 5])
def test_reorder_cache_all_plain_bit_exact(quant, t):
    """Exact f32 rows and pre-quantized (QFUSE) int8 rows: pure data
    movement, so bit-exact."""
    rng = np.random.default_rng(t)
    cache = _cache(rng, quant)
    src = rng.integers(0, N, (B, N)).astype(np.int32)
    kvg = (rng.integers(-128, 128, (B, N, L * RW[quant])).astype(np.int8)
           if quant else
           rng.standard_normal((B, N, L * RW[quant])).astype(np.float32))
    want = np.asarray(jax_reorder(jnp.asarray(kvg), jnp.asarray(cache),
                                  jnp.zeros_like(jnp.asarray(cache)),
                                  jnp.asarray(src), t, H, interpret=True))
    got = reorder_cache_all(torch.from_numpy(kvg), torch.from_numpy(cache),
                            torch.zeros(cache.shape,
                                        dtype=torch.from_numpy(cache).dtype),
                            torch.from_numpy(src), t)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_beam_gather_rows_plain_bit_exact(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, N, 3 * 128)) * 50).astype(dtype)
    src = rng.integers(0, N, (B, N)).astype(np.int32)
    want = np.asarray(jax_gather(jnp.asarray(x), jnp.asarray(src),
                                 interpret=True))
    got = beam_gather_rows(torch.from_numpy(x), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want)


def _seq_inputs(seed, quant, t=5):
    rng = np.random.default_rng(seed)
    cache = _cache(rng, quant)
    q = rng.standard_normal((B, N, F)).astype(np.float32)
    kv_new = (rng.standard_normal((B, N, 2 * F)) * 2).astype(np.float32)
    bias_hist = rng.standard_normal((Mc, H)).astype(np.float32)
    bias_hist[t:] = -1e9                      # slots >= t masked
    bias_new = rng.standard_normal((1, H)).astype(np.float32)
    return q, kv_new, cache, bias_hist, bias_new


@pytest.mark.parametrize("layer", [0, 2])
def test_step_attention_seq_plain_f32(layer):
    """Exact f32 cache: same math, sums in another order -> 1e-5."""
    q, kv_new, cache, bh, bn = _seq_inputs(layer, None)
    want = np.asarray(jax_seq(*map(jnp.asarray, (q, kv_new, cache)), layer,
                              jnp.asarray(bh), jnp.asarray(bn), H,
                              interpret=True))
    got = step_attention_seq(*map(torch.from_numpy, (q, kv_new, cache)),
                             layer, torch.from_numpy(bh),
                             torch.from_numpy(bn), H)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_step_attention_seq_plain_quantized(quant):
    """int8/int4 rows: bf16 products rounded at the reference's points;
    the sum order differs, which moves a bf16 rounding now and then ->
    1e-3. The QFUSE rows (emit_quant) are integer codec output: equal.

    XLA's CPU backend may skip intermediate bf16 roundings by default
    (xla_allow_excess_precision), which moves the reference off its own
    written math by ~5e-3 here; the reference is compiled without it."""
    q, kv_new, cache, bh, bn = _seq_inputs(7, quant)
    ref = jax.jit(lambda q_, kv_, c_, bh_, bn_: jax_seq(
        q_, kv_, c_, 1, bh_, bn_, H, interpret=True, emit_quant=quant),
        compiler_options={"xla_allow_excess_precision": False})
    want, want_q = ref(*map(jnp.asarray, (q, kv_new, cache, bh, bn)))
    got, got_q = step_attention_seq(
        *map(torch.from_numpy, (q, kv_new, cache)), 1,
        torch.from_numpy(bh), torch.from_numpy(bn), H, emit_quant=quant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_step_attention_seq_refuses_mismatched_emit():
    q, kv_new, cache, bh, bn = _seq_inputs(0, "int8")
    with pytest.raises(ValueError, match="emit_quant"):
        step_attention_seq(*map(torch.from_numpy, (q, kv_new, cache)), 0,
                           torch.from_numpy(bh), torch.from_numpy(bn), H,
                           emit_quant="int4")


def test_cpu_tensors_launch_no_kernel():
    """The wrappers take the plain version for CPU tensors: no counter
    moves."""
    before = dict(KERNEL_LAUNCHES)
    q, kv_new, cache, bh, bn = _seq_inputs(0, "int4")
    args = [torch.from_numpy(a) for a in (q, kv_new, cache, bh, bn)]
    _, kvq = step_attention_seq(*args[:3], 0, *args[3:], H,
                                emit_quant="int4")
    c = args[2]
    src = torch.zeros(B, N, dtype=torch.int32)
    out = reorder_cache_all(kvq.repeat(1, 1, L), c, torch.zeros_like(c),
                            src, 3)
    beam_gather_rows(out.reshape(B, N, -1), src)
    assert KERNEL_LAUNCHES == before
