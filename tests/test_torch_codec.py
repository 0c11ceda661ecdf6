"""Row codec of the port (ripor_tpu_torch/ops/attend_reorder.py) against
the JAX package's: bit-exact, since the codec is integer-valued."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.ops.attend_reorder import (_quantize_rows,
                                          _quantize_rows_int4, _unpack_int4,
                                          quantize_rows_xla,
                                          quantize_rows_xla_int4)
from ripor_tpu_torch.ops import attend_reorder as port

H, D = 4, 16
F = H * D


def _rows(seed, shape=(3, 5)):
    """Random K|V rows with per-row magnitudes spread over 2^-8..2^8 —
    inside |e| <= 12, where the reference's CPU exp2/log2 are exact."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-8, 8, shape + (1,)))
    return (rng.standard_normal(shape + (2 * F,)) * mag).astype(np.float32)


def _boundary_rows(qmax):
    """Rows whose every head group has absmax = qmax * 2^k exactly, for
    k in [-12, 12]: there e = k in any correct implementation."""
    ks = np.arange(-12, 13)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (len(ks), 2 * H, D)).astype(np.float32)
    x[:, :, 0] = 1.0
    x = x * (qmax * np.exp2(ks))[:, None, None].astype(np.float32)
    return x.reshape(len(ks), 2 * F), ks


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_int8_bit_exact(seed):
    x = _rows(seed)
    got = port.quantize_rows_plain(torch.from_numpy(x), H).numpy()
    np.testing.assert_array_equal(got, np.asarray(quantize_rows_xla(
        jnp.asarray(x), H)))
    q8, epad = port._quantize_rows(torch.from_numpy(x[0]), H)
    jq, je = _quantize_rows(jnp.asarray(x[0]), H)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(epad.numpy(), np.asarray(je))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_int4_bit_exact(seed):
    x = _rows(seed)
    got = port.quantize_rows_int4_plain(torch.from_numpy(x), H).numpy()
    np.testing.assert_array_equal(got, np.asarray(quantize_rows_xla_int4(
        jnp.asarray(x), H)))
    p4, epad = port._quantize_rows_int4(torch.from_numpy(x[0]), H)
    jp, je = _quantize_rows_int4(jnp.asarray(x[0]), H)
    np.testing.assert_array_equal(p4.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(epad.numpy(), np.asarray(je))


@pytest.mark.parametrize("kind,qmax", [("int8", 127.0), ("int4", 7.0)])
def test_codec_power_of_two_boundaries(kind, qmax):
    """absmax = qmax * 2^k must give exponent k, in the port and in the
    reference alike, and the packed rows must agree."""
    x, ks = _boundary_rows(qmax)
    if kind == "int8":
        got = port.quantize_rows_plain(torch.from_numpy(x), H).numpy()
        want = np.asarray(quantize_rows_xla(jnp.asarray(x), H))
        tail = got[:, 2 * F:]
    else:
        got = port.quantize_rows_int4_plain(torch.from_numpy(x), H).numpy()
        want = np.asarray(quantize_rows_xla_int4(jnp.asarray(x), H))
        tail = got[:, F:]
    np.testing.assert_array_equal(tail[:, :2 * H],
                                  np.repeat(ks[:, None], 2 * H, axis=1))
    assert not tail[:, 2 * H:].any()
    np.testing.assert_array_equal(got, want)


def test_port_codec_exact_outside_reference_range():
    """Beyond |e| > 12 the port still computes e = ceil(log2(absmax/127))
    and 2^-e exactly (the reference's CPU exp2/log2 are approximate
    there): check against exact integer arithmetic."""
    ks = np.array([-40, -31, -26, -13, 13, 26, 40])
    x = np.zeros((len(ks), 2 * F), np.float32)
    x[:, 0] = 127.0 * np.exp2(ks)          # K head 0: absmax = 127 * 2^k
    x[:, 1] = 3.5 * np.exp2(ks)            # a tie: rounds half to even
    rows = port.quantize_rows_plain(torch.from_numpy(x), H).numpy()
    np.testing.assert_array_equal(rows[:, 2 * F], ks)
    np.testing.assert_array_equal(rows[:, 0], 127)
    np.testing.assert_array_equal(rows[:, 1], 4)


def test_unpack_int4_matches_reference():
    raw = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    k, v = port._unpack_int4(torch.from_numpy(raw))
    jk, jv = _unpack_int4(jnp.asarray(raw))
    assert k.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
    np.testing.assert_array_equal(k.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(jv, np.float32))
