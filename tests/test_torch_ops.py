"""Plain versions of the port's write-then-attend kernels against the JAX
package's Pallas kernels in interpret mode, the counterpart of
tests/test_ops.py: K8 step_attention (f32 at the reference's own 2e-5
bar; bf16 at 1e-3) and K7 beam_gather_blocks (data movement: bit-equal),
plus reorder_cache_pallas (one K3 over stacked rows: bit-equal). The CUDA
kernels are held against these plain versions on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.ops.beam_gather import beam_gather_blocks as jax_blocks
from ripor_tpu.ops.beam_gather import reorder_cache_pallas as jax_reorder
from ripor_tpu.ops.step_attention import step_attention as jax_step
from ripor_tpu_torch.ops import (KERNEL_LAUNCHES, beam_gather_blocks,
                                 reorder_cache_pallas, step_attention)

B, Mc, H, D = 2, 16, 4, 8
F = H * D
NEG_INF = -1e30


def _step_inputs(seed, n, t):
    """q [B, n, F], caches [B, n, Mc, F], bias [Mc, H] with slots > t
    masked (the write-then-attend step's bias)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n, F)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, n, Mc, F)).astype(np.float32)
              for _ in range(2))
    bias = rng.standard_normal((Mc, H)).astype(np.float32)
    bias[t + 1:] = NEG_INF
    return q, ck, cv, bias


@pytest.mark.parametrize("n,t", [(24, Mc - 1), (13, 5)])
def test_step_attention_plain_f32(n, t):
    """f32, another sum order than the reference: its own 2e-5 bar
    (tests/test_ops.py). n=13 is a ragged beam count (the reference pads
    it to its chunk)."""
    q, ck, cv, bias = _step_inputs(n + t, n, t)
    want = np.asarray(jax_step(*map(jnp.asarray, (q, ck, cv, bias)), H,
                               interpret=True))
    got = step_attention(*map(torch.from_numpy, (q, ck, cv, bias)), H)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_step_attention_plain_bf16():
    """bf16: both round the probabilities to bf16 and the output to bf16.
    The softmax and the V sum run in f32 in another order, which can move
    a rounding by one f32 ulp; that flips a bf16 rounding only rarely, and
    1e-3 holds on these inputs (they agree bit for bit), while dropping
    the probability rounding moves the output by ~1.6e-2. XLA's CPU
    backend may skip that rounding by default
    (xla_allow_excess_precision), so the reference is compiled without
    it."""
    q, ck, cv, bias = _step_inputs(3, 24, 9)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, ck, cv)]
    ref = jax.jit(lambda q_, k_, v_, b_: jax_step(q_, k_, v_, b_, H,
                                                  interpret=True),
                  compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(ref(*args, jnp.asarray(bias)).astype(jnp.float32))
    got = step_attention(*(torch.from_numpy(np.array(
        a.astype(jnp.float32))).bfloat16() for a in args),
        torch.from_numpy(bias), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("C", [256, 96])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_beam_gather_blocks_plain_bit_exact(dtype, C):
    """C=96 is ragged (the reference pads it to 128), N=53 too (padded
    to its DMA chunk)."""
    rng = np.random.default_rng(C)
    G, N, R = 3, 53, 4
    cache = (rng.standard_normal((G, N, R, C)) * 50).astype(dtype)
    src = rng.integers(0, N, (G, N)).astype(np.int32)
    want = np.asarray(jax_blocks(jnp.asarray(cache), jnp.asarray(src),
                                 interpret=True))
    c = torch.from_numpy(cache)
    np.testing.assert_array_equal(
        beam_gather_blocks(c, torch.from_numpy(src)).numpy(), want)
    out = torch.zeros_like(c)
    assert beam_gather_blocks(c, torch.from_numpy(src), out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_reorder_cache_pallas_bit_exact():
    rng = np.random.default_rng(1)
    Bq, N = 2, 7
    tree = {"k": rng.standard_normal((Bq, N, 3, 8)).astype(np.float32),
            "v": rng.standard_normal((Bq, N, 24)).astype(np.float32)}
    src = rng.integers(0, N, (Bq, N)).astype(np.int32)
    want = jax_reorder({k: jnp.asarray(v) for k, v in tree.items()},
                       jnp.asarray(src), interpret=True)
    got = reorder_cache_pallas({k: torch.from_numpy(v)
                                for k, v in tree.items()},
                               torch.from_numpy(src))
    assert set(got) == set(tree)
    for k in tree:
        assert tuple(got[k].shape) == tree[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    pair = reorder_cache_pallas((torch.from_numpy(tree["k"]),
                                 torch.from_numpy(tree["v"])),
                                torch.from_numpy(src))
    assert isinstance(pair, tuple)
    np.testing.assert_array_equal(pair[1].numpy(), np.asarray(want["v"]))


def test_refuses_mismatched_shapes():
    q, ck, cv, bias = _step_inputs(0, 8, 3)
    args = list(map(torch.from_numpy, (q, ck, cv, bias)))
    with pytest.raises(ValueError, match="bias"):
        step_attention(*args[:3], args[3][:-1], H)
    c = args[1]
    with pytest.raises(ValueError, match="out"):
        beam_gather_blocks(c, torch.zeros(B, 8, dtype=torch.int32),
                           torch.zeros_like(c[:, :, :-1]))


def test_cpu_tensors_launch_no_kernel():
    before = dict(KERNEL_LAUNCHES)
    q, ck, cv, bias = _step_inputs(0, 8, 3)
    step_attention(*map(torch.from_numpy, (q, ck, cv, bias)), H)
    c = torch.from_numpy(ck)
    src = torch.zeros(B, 8, dtype=torch.int32)
    beam_gather_blocks(c, src)
    reorder_cache_pallas([c, c], src)
    assert KERNEL_LAUNCHES == before
