"""Plain versions of the port's non-deferred kernels against the JAX
package's Pallas kernels in interpret mode: K5 step_attention_fused (f32
math, another sum order: 1e-5) and K6 beam_gather_update (data movement:
bit-equal); and K5 and K8 step_attention at t5-3b's head width D = 128.
The CUDA kernels are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.ops.beam_gather import beam_gather_update as jax_update
from ripor_tpu.ops.step_attention import step_attention as jax_step
from ripor_tpu.ops.step_attention import step_attention_fused as jax_fused
from ripor_tpu_torch.ops import KERNEL_LAUNCHES
from ripor_tpu_torch.ops.beam_gather import beam_gather_update
from ripor_tpu_torch.ops.step_attention import (step_attention,
                                                step_attention_fused)

B, N, L, H, D, Mc = 2, 8, 3, 4, 16, 8
F = H * D


def _fused_inputs(seed, t, lead=(B, N), h=H, d=D, scale=1.0):
    rng = np.random.default_rng(seed)
    f = h * d
    cache = (rng.standard_normal((L, 2, *lead, Mc, f)) * scale).astype(
        np.float32)
    q, k_new, v_new = ((rng.standard_normal((*lead, f)) * scale).astype(
        np.float32) for _ in range(3))
    bias_hist = rng.standard_normal((Mc, h)).astype(np.float32)
    bias_hist[t:] = -1e30                     # slots >= t masked
    bias_new = rng.standard_normal((1, h)).astype(np.float32)
    return q, k_new, v_new, cache, bias_hist, bias_new


@pytest.mark.parametrize("layer,t", [(0, 0), (2, 5), (1, Mc - 1)])
def test_step_attention_fused_plain_f32(layer, t):
    q, k_new, v_new, cache, bh, bn = _fused_inputs(layer + t, t)
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k_new, v_new, cache)),
                                layer, jnp.asarray(bh), jnp.asarray(bn), H,
                                chunk=N, interpret=True))
    got = step_attention_fused(*map(torch.from_numpy,
                                    (q, k_new, v_new, cache)),
                               layer, torch.from_numpy(bh),
                               torch.from_numpy(bn), H)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_step_attention_fused_plain_computes_in_f32():
    """bf16 inputs: the plain version computes in f32 and rounds once, at
    the output, as the reference's kernel does."""
    q, k_new, v_new, cache, bh, bn = _fused_inputs(9, 4)
    args32 = [torch.from_numpy(a).bfloat16().float()
              for a in (q, k_new, v_new, cache)]
    want = step_attention_fused(*args32, 1, torch.from_numpy(bh),
                                torch.from_numpy(bn), H).bfloat16()
    got = step_attention_fused(*(a.bfloat16() for a in args32), 1,
                               torch.from_numpy(bh), torch.from_numpy(bn), H)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


# t5-3b's head width on a toy lead: two heads of D = 128, one batch row of
# four beams; scale 0.2 keeps the 128-term scores in softmax's range
D3B, H3B, LEAD = 128, 2, (1, 4)


@pytest.mark.parametrize("layer,t", [(0, 0), (1, 5), (2, Mc - 1)])
def test_step_attention_fused_plain_head_width_128(layer, t):
    q, k_new, v_new, cache, bh, bn = _fused_inputs(
        40 + t, t, LEAD, H3B, D3B, scale=0.2)
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k_new, v_new, cache)),
                                layer, jnp.asarray(bh), jnp.asarray(bn), H3B,
                                chunk=LEAD[1], interpret=True))
    got = step_attention_fused(*map(torch.from_numpy,
                                    (q, k_new, v_new, cache)),
                               layer, torch.from_numpy(bh),
                               torch.from_numpy(bn), H3B)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t", [0, Mc // 2, Mc - 1])
def test_step_attention_plain_head_width_128(dtype, t):
    """K8 at D = 128: f32 at the reference's 2e-5 bar, bf16 at 1e-3 against
    the reference compiled without excess precision (tests/test_torch_ops.py
    says why)."""
    q, _, _, cache, bias, _ = _fused_inputs(50 + t, t + 1, LEAD, H3B, D3B,
                                            scale=0.2)
    ck, cv = cache[0, 0], cache[0, 1]
    if dtype == "f32":
        want = np.asarray(jax_step(*map(jnp.asarray, (q, ck, cv, bias)), H3B,
                                   interpret=True))
        got = step_attention(*map(torch.from_numpy, (q, ck, cv, bias)), H3B)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        return
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv)]
    ref = jax.jit(lambda q_, k_, v_, b_: jax_step(q_, k_, v_, b_, H3B,
                                                  interpret=True),
                  compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(ref(*args, jnp.asarray(bias)).astype(jnp.float32))
    got = step_attention(*(torch.from_numpy(np.array(
        a.astype(jnp.float32))).bfloat16() for a in args),
        torch.from_numpy(bias), H3B)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("n,t", [(8, 0), (8, 3), (7, Mc - 1)])
def test_beam_gather_update_plain_bit_exact(dtype, n, t):
    """Slot t (first, middle, last) takes kv_gathered; n=7 is a ragged
    beam count (the reference pads it to its chunk)."""
    rng = np.random.default_rng(n + t)
    G = 2 * L * B
    cache = (rng.standard_normal((G, n, Mc, F)) * 50).astype(dtype)
    kvg = (rng.standard_normal((G, n, F)) * 50).astype(dtype)
    src = rng.integers(0, n, (G, n)).astype(np.int32)
    want = np.asarray(jax_update(jnp.asarray(cache), jnp.asarray(kvg),
                                 jnp.asarray(src), t, interpret=True))
    c = torch.from_numpy(cache)
    out = torch.zeros_like(c)
    got = beam_gather_update(c, torch.from_numpy(kvg), torch.from_numpy(src),
                             t, out)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_gather_update_matches_aliased_body():
    """The reference's aliased body (_gather_update_kernel_aliased, under
    ``dest=``: the output written into a ping-pong buffer) is K6 writing
    into its ``out`` buffer: bit-exact, and the buffer's old contents
    play no part."""
    rng = np.random.default_rng(9)
    G = 2 * L * B
    cache = (rng.standard_normal((G, N, Mc, F)) * 50).astype(np.float32)
    kvg = (rng.standard_normal((G, N, F)) * 50).astype(np.float32)
    src = rng.integers(0, N, (G, N)).astype(np.int32)
    dest = (rng.standard_normal(cache.shape) * 50).astype(np.float32)
    want = np.asarray(jax_update(jnp.asarray(cache), jnp.asarray(kvg),
                                 jnp.asarray(src), 5, jnp.asarray(dest),
                                 interpret=True))
    out = torch.from_numpy(dest.copy())
    got = beam_gather_update(torch.from_numpy(cache), torch.from_numpy(kvg),
                             torch.from_numpy(src), 5, out)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_gather_update_refuses_slot_outside_cache():
    c = torch.zeros(2, 3, Mc, F)
    with pytest.raises(ValueError, match="slot"):
        beam_gather_update(c, torch.zeros(2, 3, F),
                           torch.zeros(2, 3, dtype=torch.int32), Mc,
                           torch.zeros_like(c))


def test_cpu_tensors_launch_no_kernel():
    before = dict(KERNEL_LAUNCHES)
    q, k_new, v_new, cache, bh, bn = _fused_inputs(0, 3)
    step_attention_fused(*map(torch.from_numpy, (q, k_new, v_new, cache)), 0,
                         torch.from_numpy(bh), torch.from_numpy(bn), H)
    c = torch.from_numpy(cache).reshape(2 * L * B, N, Mc, F)
    beam_gather_update(c, c[:, :, 0].contiguous(),
                       torch.zeros(2 * L * B, N, dtype=torch.int32), 3,
                       torch.empty_like(c))
    assert KERNEL_LAUNCHES == before
