"""The megarow dataflows behind the reference's switches, as the port's
explicit arguments: quantize-on-insert (K1', ``qfuse=False``; the
reference's RIPOR_MR_QFUSE=0), the fused kvg gather (K1'',
``fused_kvg=True``; RIPOR_MR_FUSED_KVG=1) and the MXU math (K2',
``mxu_math=True``; RIPOR_MR_MXU=1). Plain versions against the JAX
package's Pallas kernels in interpret mode, and the port's searches
against the JAX searches under the same switch (the reference's module
switches set as tests/test_beam.py:508-735 sets them). The CUDA bodies
are held against these plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ripor_tpu.ops.megarow as mr
from ripor_tpu.decode.beam import make_beam_search_fn as jax_make
from ripor_tpu.ops.attend_reorder import (quantize_rows_xla,
                                          quantize_rows_xla_int4)
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu.trie.succinct import succinct_tables as jax_tables
from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
from ripor_tpu_torch.ops import KERNEL_LAUNCHES
from ripor_tpu_torch.ops.megarow import (reorder_cache_all,
                                         reorder_cache_all_plain,
                                         step_attention_seq)
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch
from torch_parity import port_model, setup

B, N, L, H, D, Mc = 2, 8, 3, 4, 16, 8
F = H * D
RW = {None: 2 * F, "int8": 2 * F + 128, "int4": F + 128}
QFN = {"int8": quantize_rows_xla, "int4": quantize_rows_xla_int4}
NO_EXCESS = {"xla_allow_excess_precision": False}


@contextlib.contextmanager
def switches(**kw):
    """The JAX package's megarow module switches (QFUSE, FUSED_KVG,
    MXU_MATH) set for the block, with its compile caches cleared on the
    way in and out."""
    old = {k: getattr(mr, k) for k in kw}
    try:
        for k, v in kw.items():
            setattr(mr, k, v)
        jax.clear_caches()
        yield
    finally:
        for k, v in old.items():
            setattr(mr, k, v)
        jax.clear_caches()


def _exact_rows(rng, lead):
    """Exact K|V rows with per-row magnitudes 2^-4..2^8: every quantizer
    exponent within |e| <= 12, where the reference's CPU exp2/log2 are
    exact (tests/test_torch_codec.py)."""
    mag = np.exp2(rng.uniform(-4, 8, lead + (1,)))
    return (rng.standard_normal(lead + (2 * F,)) * mag).astype(np.float32)


def _cache(rng, quant):
    kv = _exact_rows(rng, (B, N, L, Mc))
    if quant is None:
        return kv
    return np.array(QFN[quant](jnp.asarray(kv), H))


def _bf16(x):
    """f32 values rounded to bf16 (still float32), so both sides take the
    same bf16 rows."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _jax_reorder(kvg, cache, src, t, fused, bf16=False):
    k = jnp.asarray(kvg, jnp.bfloat16 if bf16 else None)
    return np.asarray(mr.reorder_cache_all(
        k, jnp.asarray(cache), jnp.zeros_like(jnp.asarray(cache)),
        jnp.asarray(src), t, H, interpret=True, fused_kvg=fused))


def _port_reorder(kvg, cache, src, t, fused, bf16=False):
    k = torch.from_numpy(kvg)
    c = torch.from_numpy(cache)
    return reorder_cache_all(k.bfloat16() if bf16 else k, c,
                             torch.zeros_like(c), torch.from_numpy(src), t,
                             H, fused_kvg=fused).numpy()


@pytest.mark.parametrize("quant,t,bf16", [
    ("int8", 0, False), ("int8", 5, True), ("int4", 0, False),
    ("int4", 7, True)])
def test_quantize_on_insert_plain_bit_exact(quant, t, bf16):
    """K1': exact kvg rows into an int8 cache, quantized on insert to the
    cache's rows (int4 where RW == F + SCALE_COLS): integer codec output
    and data movement, so bit-exact."""
    rng = np.random.default_rng(t + 10 * bf16)
    cache = _cache(rng, quant)
    src = rng.integers(0, N, (B, N)).astype(np.int32)
    kvg = _exact_rows(rng, (B, N, L)).reshape(B, N, L * 2 * F)
    if bf16:
        kvg = _bf16(kvg)
    want = _jax_reorder(kvg, cache, src, t, False, bf16)
    np.testing.assert_array_equal(
        _port_reorder(kvg, cache, src, t, False, bf16), want)


@pytest.mark.parametrize("form", ["int8 rows", "int8 quantized",
                                  "int4 quantized", "f32 exact"])
def test_fused_kvg_plain_bit_exact(form):
    """K1'': kvg un-permuted, row src[b, n] inserted into beam n, in the
    verbatim int8 (QFUSE), quantize-on-insert and exact forms."""
    rng = np.random.default_rng(3)
    quant = None if form == "f32 exact" else form.split()[0]
    cache = _cache(rng, quant)
    src = rng.integers(0, N, (B, N)).astype(np.int32)
    if form == "int8 rows":
        kvg = np.array(quantize_rows_xla(jnp.asarray(
            _exact_rows(rng, (B, N, L))), H)).reshape(B, N, -1)
    else:
        kvg = _exact_rows(rng, (B, N, L)).reshape(B, N, -1)
    want = _jax_reorder(kvg, cache, src, 4, True)
    np.testing.assert_array_equal(_port_reorder(kvg, cache, src, 4, True),
                                  want)


def test_fused_kvg_is_the_gather_then_the_insert():
    """fused_kvg on un-permuted rows equals the unfused call on the rows
    gathered by src (the dataflow's K3 then K1)."""
    rng = np.random.default_rng(4)
    cache = torch.from_numpy(_cache(rng, "int4"))
    src = torch.from_numpy(rng.integers(0, N, (B, N)).astype(np.int32))
    kvg = torch.from_numpy(_exact_rows(rng, (B, N, L)).reshape(B, N, -1))
    gathered = kvg[torch.arange(B)[:, None], src.long()]
    a = reorder_cache_all_plain(kvg, cache, torch.empty_like(cache), src, 3,
                                H, fused_kvg=True)
    b = reorder_cache_all_plain(gathered, cache, torch.empty_like(cache),
                                src, 3, H)
    assert torch.equal(a, b)


def test_quantize_on_insert_needs_num_heads():
    c = torch.zeros(B, N, L, Mc, RW["int4"], dtype=torch.int8)
    with pytest.raises(ValueError, match="num_heads"):
        reorder_cache_all(torch.zeros(B, N, L * 2 * F), c, torch.zeros_like(c),
                          torch.zeros(B, N, dtype=torch.int32), 1)


def _seq_inputs(rng, quant, t=5):
    cache = _cache(rng, quant)
    q = rng.standard_normal((B, N, F)).astype(np.float32)
    kv_new = (rng.standard_normal((B, N, 2 * F)) * 2).astype(np.float32)
    bias_hist = rng.standard_normal((Mc, H)).astype(np.float32)
    bias_hist[t:] = -1e9
    bias_new = rng.standard_normal((1, H)).astype(np.float32)
    return q, kv_new, cache, bias_hist, bias_new


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_mxu_math_plain_matches_reference_math(quant):
    """K2' plain version against _seq_math_quant_mxu itself on one layer's
    rows (C = B*N beams), compiled without excess precision: bf16 k*q
    products and probabilities, exact p*v products, f32 sums in another
    order -> 1e-3."""
    rng = np.random.default_rng(11)
    q, kv_new, cache, bh, bn = _seq_inputs(rng, quant)
    layer = 2
    rows = cache[:, :, layer].reshape(B * N, Mc, -1)
    ref = jax.jit(lambda q_, kv_, r_, bh_, bn_: mr._seq_math_quant_mxu(
        q_, kv_, bh_, bn_, r_, H, quant), compiler_options=NO_EXCESS)
    want = np.asarray(ref(*map(jnp.asarray, (
        q.reshape(B * N, F), kv_new.reshape(B * N, 2 * F), rows, bh, bn))))
    got = step_attention_seq(*map(torch.from_numpy, (q, kv_new, cache)),
                             layer, torch.from_numpy(bh),
                             torch.from_numpy(bn), H, mxu_math=True)
    np.testing.assert_allclose(got.numpy().reshape(B * N, F), want,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_mxu_math_plain_matches_jax_kernel(quant):
    """K2' against the JAX step_attention_seq (interpret mode) under
    MXU_MATH, with the QFUSE rows (bit-equal) and at the megarow bar of
    1e-3; off the switch the two maths differ by more."""
    rng = np.random.default_rng(12)
    q, kv_new, cache, bh, bn = _seq_inputs(rng, quant)
    args = [torch.from_numpy(a) for a in (q, kv_new, cache)]
    with switches(MXU_MATH=True):
        ref = jax.jit(lambda q_, kv_, c_, bh_, bn_: mr.step_attention_seq(
            q_, kv_, c_, 1, bh_, bn_, H, interpret=True, emit_quant=quant),
            compiler_options=NO_EXCESS)
        want, want_q = ref(*map(jnp.asarray, (q, kv_new, cache, bh, bn)))
    got, got_q = step_attention_seq(*args, 1, torch.from_numpy(bh),
                                    torch.from_numpy(bn), H,
                                    emit_quant=quant, mxu_math=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    default = step_attention_seq(*args, 1, torch.from_numpy(bh),
                                 torch.from_numpy(bn), H)
    assert not torch.equal(default, got)


def test_mxu_math_has_no_effect_on_an_exact_cache():
    rng = np.random.default_rng(13)
    q, kv_new, cache, bh, bn = _seq_inputs(rng, None)
    args = [torch.from_numpy(a) for a in (q, kv_new, cache)]
    before = dict(KERNEL_LAUNCHES)
    a = step_attention_seq(*args, 0, torch.from_numpy(bh),
                           torch.from_numpy(bn), H)
    b = step_attention_seq(*args, 0, torch.from_numpy(bh),
                           torch.from_numpy(bn), H, mxu_math=True)
    assert torch.equal(a, b)
    assert KERNEL_LAUNCHES == before        # CPU tensors: no kernel


# ---------------------------------------------------------------------------
# the searches (tests/torch_parity.py::setup, beam 5, cache_segments=3)
# ---------------------------------------------------------------------------

BEAMS = 5


@pytest.fixture(scope="module")
def world():
    cfg, params, ids, mask, doc_codes = setup(M=6, K=8, n_docs=40,
                                              jax_init=False)
    jtables = jax.tree.map(jnp.asarray, jax_tables(jax_build_trie(doc_codes,
                                                                  8)))
    tables = tables_to_torch(succinct_tables(build_trie(doc_codes, 8)),
                             "cpu")
    return dict(cfg=cfg, params=params, ids=ids, mask=mask, jtables=jtables,
                tables=tables, model=port_model(params, cfg), port={})


def _jax(w, quant, sw):
    with switches(**sw):
        fn = jax_make(w["cfg"], BEAMS, constrained=True, dtype=jnp.float32,
                      use_pallas_gather=False, megarow=True,
                      cache_segments=3, kv_cache_quant=quant)
        return tuple(np.asarray(a) for a in fn(
            w["params"], jnp.asarray(w["ids"]), jnp.asarray(w["mask"]),
            w["jtables"]))


def _port(w, quant, **kw):
    key = (quant, tuple(sorted(kw.items())))
    if key not in w["port"]:
        fn = make_beam_search_fn(w["cfg"], BEAMS, constrained=True,
                                 dtype=torch.float32, cache_segments=3,
                                 kv_cache_quant=quant, device="cpu", **kw)
        w["port"][key] = tuple(a.numpy() for a in fn(
            w["model"], w["ids"], w["mask"], w["tables"]))
    return w["port"][key]


def _code_sets_within_one(got, want):
    """The reference's int4 / MXU gates (tests/test_beam.py:490-506,
    :707-735): the top beam equal, the live code sets differ by at most
    one."""
    s1, c1, _ = got
    s0, c0, _ = want
    np.testing.assert_array_equal(c1[:, 0], c0[:, 0])
    for b in range(s0.shape[0]):
        set0 = {tuple(r) for r, sc in zip(c0[b], s0[b]) if sc > NEG_INF / 2}
        set1 = {tuple(r) for r, sc in zip(c1[b], s1[b]) if sc > NEG_INF / 2}
        assert len(set0 & set1) >= min(len(set0), len(set1)) - 1, \
            (b, set0, set1)


def _exact_parity(got, want):
    """The f32 exact-cache megarow bar (tests/test_torch_beam.py): scores
    within 1e-5, codes and states equal on live beams."""
    s1, c1, st1 = got
    s0, c0, st0 = want
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-5)
    live = s0 > NEG_INF / 2
    np.testing.assert_array_equal(live, s1 > NEG_INF / 2)
    np.testing.assert_array_equal(c1[live], c0[live])
    np.testing.assert_array_equal(st1[live], st0[live])


# (case, cache, port arguments, JAX switches, bar). The combinations
# (fused with qfuse off, kvg_quant_xla with qfuse off) are held bit for
# bit against the port's default below, which tests/test_torch_beam.py
# holds against the JAX search.
AGAINST_JAX = [
    ("qfuse off", "int4", dict(qfuse=False), dict(QFUSE=False),
     _code_sets_within_one),
    ("fused", "int4", dict(fused_kvg=True), dict(FUSED_KVG=True),
     _code_sets_within_one),
    ("fused", None, dict(fused_kvg=True), dict(FUSED_KVG=True),
     _exact_parity),
    ("mxu", "int4", dict(mxu_math=True), dict(MXU_MATH=True),
     _code_sets_within_one),
]


@pytest.mark.parametrize("case,quant,kw,sw,bar", AGAINST_JAX,
                         ids=[f"{c[0]} {c[1] or 'f32'}" for c in AGAINST_JAX])
def test_dataflow_matches_jax_under_its_switch(world, case, quant, kw, sw,
                                               bar):
    bar(_port(world, quant, **kw), _jax(world, quant, sw))


@pytest.mark.parametrize("quant,kw", [
    ("int4", dict(qfuse=False)),
    ("int4", dict(fused_kvg=True)),
    ("int4", dict(fused_kvg=True, qfuse=False)),
    ("int4", dict(qfuse=False, kvg_quant_xla=True)),
    ("int8", dict(qfuse=False)),
    ("int8", dict(fused_kvg=True, qfuse=False)),
    (None, dict(fused_kvg=True)),
])
def test_dataflow_bit_identical_to_default(world, quant, kw):
    """The reference's own bar for QFUSE and FUSED_KVG
    (tests/test_beam.py:508-573): every kvg dataflow inserts the same
    bytes, so scores, codes and states equal the default's."""
    got, want = _port(world, quant, **kw), _port(world, quant)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant,kw", [
    (None, dict(qfuse=False, mxu_math=True, kvg_quant_xla=None)),
    ("int4", dict(megarow=False, qfuse=False, fused_kvg=True,
                  mxu_math=True)),
])
def test_switches_without_effect(world, quant, kw):
    """As the reference's switches: qfuse and mxu_math change nothing on
    an exact cache, and none of the three off the megarow path."""
    base = {k: v for k, v in kw.items() if k == "megarow"}
    got, want = _port(world, quant, **kw), _port(world, quant, **base)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
