"""The port's data- and tensor-parallel beam search over a 4-rank gloo
world (data=2 x model=2, tests/torch_mesh_ranks.py) against the JAX
package's single-device search on the same inputs and params, at the JAX
package's own bars (tests/test_sharded_decode.py, one test each).

Every rank returns the whole batch's results, so every rank's must be
equal: for tensor parallelism that is the two model ranks agreeing on
every pick. Dead beams (score NEG_INF) hold filler whose order torch.topk
and lax.top_k break differently, so codes and states are compared on live
beams, and in full where every beam is live."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from ripor_tpu.decode.beam import make_beam_search_fn as jax_make
from ripor_tpu.models import ripor_small
from ripor_tpu.trie import build_trie, succinct_tables
from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
from ripor_tpu_torch.parallel import split_sums
from ripor_tpu_torch.trie import build_trie as port_build_trie
from ripor_tpu_torch.trie import succinct_tables as port_tables
from ripor_tpu_torch.trie import tables_to_torch
from torch_parity import port_model, port_state_dict, seeded_params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = ripor_small(M=4, K=8)
    doc_codes = np.random.default_rng(100).integers(0, 8, (60, 4))
    cases, inputs = {}, {"docs": doc_codes}
    for name, _, seed, _, _ in ranks.DECODE_CASES:
        ids = np.random.default_rng(seed).integers(1, 90, (8, 9)).astype(
            np.int32)
        params, mask = seeded_params(cfg, seed), np.ones_like(ids)
        cases[name] = (params, ids, mask)
        n = 5 if name == "ragged" else 8
        inputs[name] = (port_state_dict(params, cfg), ids[:n], mask[:n])
    handle = ranks.start("decode", inputs,
                         tmp_path_factory.mktemp("sharded_decode"))

    # the single-device references, computed while the ranks run: the JAX
    # package's exact f32 search (its XLA path on the CPU; the ragged
    # case's first 5 queries search as they do in a batch of 8), and the
    # port's single-device int4 and ffn_int8 megarow searches, the tight
    # baselines of the quantized TP bars
    tables = jax.tree.map(jnp.asarray,
                          succinct_tables(build_trie(doc_codes, 8)))
    port_tt = tables_to_torch(port_tables(port_build_trie(doc_codes, 8)),
                              "cpu")
    fns = {b: jax_make(cfg, b, dtype=jnp.float32, use_pallas_gather=False)
           for b in (4, 5)}
    want = {}
    for name, _, _, beams, kw in ranks.DECODE_CASES:
        params, ids, mask = cases[name]
        want[name] = tuple(np.asarray(a) for a in fns[beams](
            params, jnp.asarray(ids), jnp.asarray(mask), tables))
        if name in ("tp_megarow_int4", "tp_ffn_int8", "tp_bf16_int4"):
            dtype = getattr(torch, kw.get("dtype", "float32"))
            fn = make_beam_search_fn(cfg, beams, device="cpu",
                                     **dict(kw, dtype=dtype))
            model = port_model(params, cfg, dtype)
            want[name + "_1"] = tuple(a.numpy() for a in fn(
                model, ids, mask, port_tt))
            if name == "tp_bf16_int4":
                with split_sums(model):
                    want[name + "_split"] = tuple(a.numpy() for a in fn(
                        model, ids, mask, port_tt))
    got = ranks.collect(handle)
    return got, want, cases


def _same_on_every_rank(got, name):
    for r in got[1:]:
        for a, b in zip(r[name], got[0][name]):
            np.testing.assert_array_equal(a, b)
    return got[0][name]


def _live_equal(a, b, live):
    np.testing.assert_array_equal(a[live], b[live])
    if live.all():
        np.testing.assert_array_equal(a, b)


def _exact(got, want, rtol, atol=0.0):
    s1, c1, st1 = got
    s0, c0, st0 = want
    np.testing.assert_allclose(s1, s0, rtol=rtol, atol=atol)
    live = s0 > NEG_INF / 2
    np.testing.assert_array_equal(live, s1 > NEG_INF / 2)
    _live_equal(c1, c0, live)
    _live_equal(st1, st0, live)


def test_sharded_beam_search_parity(world):
    got, want, _ = world
    _exact(_same_on_every_rank(got, "dp_exact"), want["dp_exact"], 1e-5)


def test_sharded_beam_search_int8_cache(world):
    got, want, _ = world
    s_q8, c_q8, _ = _same_on_every_rank(got, "dp_int8")
    s_1, c_1, _ = want["dp_int8"]
    live = s_1 > NEG_INF / 2
    np.testing.assert_allclose(s_q8[live], s_1[live], rtol=0.05, atol=0.05)
    np.testing.assert_array_equal(c_q8[:, 0], c_1[:, 0])


def test_tp_beam_search_parity(world):
    got, want, _ = world
    _exact(_same_on_every_rank(got, "tp_exact"), want["tp_exact"], 2e-5,
           1e-5)


def test_tp_keeps_its_rank_model_until_the_params_change(world):
    """A second call with the same params gives the same results; after an
    in-place change to them, a call gives what a new search function
    gives, not the results of the kept model."""
    got, want, _ = world
    first = got[0]["tp_exact"]
    for r in got:
        again, changed, fresh = r["tp_cache"]
        for a, b in zip(again, first):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(changed, fresh):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(changed[0], first[0])


def test_tp_beam_search_int8_deferred(world):
    got, want, _ = world
    s_tp, c_tp, _ = _same_on_every_rank(got, "tp_int8")
    s_1, c_1, _ = want["tp_int8"]
    live = s_1 > NEG_INF / 2
    np.testing.assert_allclose(s_tp[live], s_1[live], rtol=0.05, atol=0.25)
    np.testing.assert_array_equal(c_tp[:, 0], c_1[:, 0])


def test_sharded_ragged_batch_pad_and_error(world):
    got, want, cases = world
    _, ids, mask = cases["ragged"]
    for r in got:
        assert "pad_batch_to_data_axis" in r["ragged_error"]
        pids, pmask, n = r["ragged_pad"]
        assert n == 5 and pids.shape[0] == 6
        np.testing.assert_array_equal(pids[:5], ids[:5])
        np.testing.assert_array_equal(pids[5:], ids[4:5])
        np.testing.assert_array_equal(pmask[5:], mask[4:5])
    s, c, st = _same_on_every_rank(got, "ragged")
    _exact((s[:5], c[:5], st[:5]), tuple(a[:5] for a in want["ragged"]),
           1e-5)


def test_sharded_megarow_matches_single_device(world):
    got, want, _ = world
    _exact(_same_on_every_rank(got, "dp_megarow"), want["dp_megarow"], 1e-5,
           1e-5)


def test_tp_megarow_int4_matches_single_device(world):
    """Against the port's single-device megarow int4 search, the tight
    baseline (int4 scales are per head, so each shard quantizes its heads
    as the whole model does), at the JAX bar; against the JAX package's
    exact search, at the int4 bar of tests/test_beam.py:481-506."""
    got, want, _ = world
    s_tp, c_tp, _ = _same_on_every_rank(got, "tp_megarow_int4")
    s_1, c_1, _ = want["tp_megarow_int4_1"]
    live = s_1 > NEG_INF / 2
    np.testing.assert_allclose(s_tp[live], s_1[live], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(c_tp[live], c_1[live])
    s_e, c_e, _ = want["tp_megarow_int4"]
    np.testing.assert_array_equal(c_tp[:, 0], c_e[:, 0])
    for b in range(s_e.shape[0]):
        set_e = {tuple(r) for r, sc in zip(c_e[b], s_e[b]) if sc > -1e29}
        set_tp = {tuple(r) for r, sc in zip(c_tp[b], s_tp[b]) if sc > -1e29}
        assert len(set_e & set_tp) >= min(len(set_e), len(set_tp)) - 1


def test_tp_megarow_exact_matches_megarow(world):
    got, want, _ = world
    _exact(_same_on_every_rank(got, "tp_megarow_exact"),
           want["tp_megarow_exact"], 2e-5, 1e-5)


def test_tp_ffn_int8_matches_single_device_ffn_int8(world):
    got, want, _ = world
    s_tp, c_tp, _ = _same_on_every_rank(got, "tp_ffn_int8")
    s_1, c_1, _ = want["tp_ffn_int8_1"]
    _, c_e, _ = want["tp_ffn_int8"]
    live = s_1 > NEG_INF / 2
    np.testing.assert_allclose(s_tp[live], s_1[live], rtol=0.05, atol=0.25)
    np.testing.assert_array_equal(c_tp[:, 0], c_e[:, 0])
    np.testing.assert_array_equal(c_1[:, 0], c_e[:, 0])


def test_tp_refuses_heads_that_do_not_divide_the_model_axis(world):
    got, _, _ = world
    for r in got:
        assert "must divide the model axis (2)" in r["tp_heads_error"]


def test_tp_bf16_matches_single_device(world):
    """Beyond the JAX package's tests: a bf16 TP search with an int4 cache
    (chip_smoke.py phase 12's path, at a toy size). The partial products
    are summed in bf16, as the JAX package's psum takes them, so TP is
    exactly a one-process search whose output projections take the same
    two partial sums (parallel/reference.py::split_sums), and against the
    plain one-process search it holds ROADMAP's int4 bar: top beam equal,
    code sets differing by at most one."""
    got, want, _ = world
    s_tp, c_tp, st_tp = _same_on_every_rank(got, "tp_bf16_int4")
    s_sp, c_sp, st_sp = want["tp_bf16_int4_split"]
    live = s_sp > NEG_INF / 2
    np.testing.assert_array_equal(live, s_tp > NEG_INF / 2)
    np.testing.assert_array_equal(s_tp[live], s_sp[live])
    _live_equal(c_tp, c_sp, live)
    _live_equal(st_tp, st_sp, live)
    s_1, c_1, _ = want["tp_bf16_int4_1"]
    np.testing.assert_array_equal(c_tp[:, 0], c_1[:, 0])
    for b in range(s_1.shape[0]):
        set_1 = {tuple(r) for r, sc in zip(c_1[b], s_1[b]) if sc > -1e29}
        set_tp = {tuple(r) for r, sc in zip(c_tp[b], s_tp[b]) if sc > -1e29}
        assert len(set_1 & set_tp) >= min(len(set_1), len(set_tp)) - 1


def test_split_sums_mirrors_the_modules_and_refuses_what_it_cannot():
    """parallel/reference.py::split_sums, the one-process reference of the
    bf16 TP search: on a gated FFN and an attention block it leaves f32
    outputs within rounding of the plain ones (only the projection's
    contraction is split); it refuses a per-rank model, and an ffn_int8
    search, whose decoder applies a quantized wo it does not mirror."""
    import dataclasses

    from ripor_tpu_torch.models import RiporModel, init_params
    from ripor_tpu_torch.models import ripor_small as port_small
    from ripor_tpu_torch.models.layers import Attention, FeedForward

    cfg = port_small(M=4, K=8)
    gated = dataclasses.replace(cfg.t5, feed_forward_proj="gated-gelu")
    torch.manual_seed(0)
    x = torch.randn(2, 3, gated.d_model)
    for module in (FeedForward(gated), Attention(gated)):
        for p in module.parameters():
            p.data.normal_(0, 0.2)
        want = module(x)
        with split_sums(module, parts=2):
            got = module(x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert "forward" not in vars(module.o if isinstance(
            module, Attention) else module.wo)

    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(sd)
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 90, (2, 9)).astype(np.int32)
    tables = tables_to_torch(port_tables(port_build_trie(
        rng.integers(0, 8, (30, 4)), 8)), "cpu")
    fn = make_beam_search_fn(cfg, 4, dtype=torch.float32, device="cpu",
                             megarow=True, cache_segments=2, ffn_int8=True)
    with pytest.raises(RuntimeError, match="ffn_int8"):
        with split_sums(model):
            fn(model, ids, np.ones_like(ids), tables)
    model.decoder.layers[0].self_attn.tp_group = object()
    with pytest.raises(ValueError, match="one-process"):
        with split_sums(model):
            pass
