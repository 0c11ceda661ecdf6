"""The port's megarow beam search (plain kernel versions on the CPU)
against the JAX package: its megarow path (Pallas kernels in interpret
mode) and its XLA path, at the JAX package's own path-vs-path bars
(tests/test_beam.py:404-506).

Dead beams (score NEG_INF) hold filler whose order is not defined —
torch.topk and lax.top_k break ties differently — so codes and states are
compared on live beams, and in full where every beam is live."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.decode.beam import expand_groups_to_docids as jax_expand
from ripor_tpu.decode.beam import make_beam_search_fn as jax_make
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu.trie.succinct import succinct_tables as jax_tables
from ripor_tpu_torch.decode.beam import (NEG_INF, beam_search,
                                         expand_groups_to_docids,
                                         make_beam_search_fn)
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch
from torch_parity import port_model, port_state_dict, setup

BEAMS = 5


def _world(M, K, n_docs, segments, doc_codes=None):
    cfg, params, ids, mask, codes = setup(M=M, K=K, n_docs=n_docs)
    doc_codes = codes if doc_codes is None else doc_codes(codes)
    jtables = jax.tree.map(jnp.asarray, jax_tables(jax_build_trie(doc_codes,
                                                                  K)))
    trie = build_trie(doc_codes, K)
    tables = tables_to_torch(succinct_tables(trie), "cpu")
    ref = jax_make(cfg, BEAMS, constrained=True, dtype=jnp.float32,
                   use_pallas_gather=False, deferred=False)
    xla = tuple(np.asarray(a) for a in ref(params, jnp.asarray(ids),
                                           jnp.asarray(mask), jtables))
    return dict(cfg=cfg, params=params, ids=ids, mask=mask, trie=trie,
                tables=tables, jtables=jtables, xla=xla, segments=segments,
                model=port_model(params, cfg))


@pytest.fixture(scope="module")
def world():
    return _world(6, 8, 40, 3)


def _branching(codes):
    """The first two positions from 4 codes, so the beams branch there
    before they follow the documents' own codes up to 1,023."""
    codes = codes.copy()
    codes[:, :2] %= 4
    return codes


@pytest.fixture(scope="module")
def world_1024():
    """RIPOR's 16x1024 DocID geometry at toy widths: the port's trie codes
    are int16 on the device and a beam's bitmask row is 32 words; 4 cache
    segments, as the engine runs M=16."""
    return _world(16, 1024, 60, 4, _branching)


def _jax_megarow(w, quant):
    fn = jax_make(w["cfg"], BEAMS, constrained=True, dtype=jnp.float32,
                  use_pallas_gather=False, megarow=True,
                  cache_segments=w["segments"],
                  kv_cache_quant=quant)
    return tuple(np.asarray(a) for a in fn(w["params"], jnp.asarray(w["ids"]),
                                           jnp.asarray(w["mask"]),
                                           w["jtables"]))


def _port(w, quant, constrained=True):
    fn = make_beam_search_fn(w["cfg"], BEAMS, constrained=constrained,
                             dtype=torch.float32,
                             cache_segments=w["segments"],
                             kv_cache_quant=quant, device="cpu")
    return tuple(a.numpy() for a in fn(w["model"], w["ids"], w["mask"],
                                       w["tables"]))


def _assert_exact_parity(got, want):
    s1, c1, st1 = got
    s0, c0, st0 = want
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-5)
    live = s0 > NEG_INF / 2
    np.testing.assert_array_equal(live, s1 > NEG_INF / 2)
    np.testing.assert_array_equal(c1[live], c0[live])
    np.testing.assert_array_equal(st1[live], st0[live])
    if live.all():
        np.testing.assert_array_equal(c1, c0)
        np.testing.assert_array_equal(st1, st0)


def test_exact_cache_matches_jax_megarow(world):
    _assert_exact_parity(_port(world, None), _jax_megarow(world, None))


def test_exact_cache_matches_jax_xla_path(world):
    _assert_exact_parity(_port(world, None), world["xla"])


@pytest.mark.parametrize("against", ["megarow", "xla"])
def test_int8_cache_close(world, against):
    s1, c1, _ = _port(world, "int8")
    s0, c0, _ = (_jax_megarow(world, "int8") if against == "megarow"
                 else world["xla"])
    live = s0 > NEG_INF / 2
    np.testing.assert_allclose(s1[live], s0[live], rtol=0.05, atol=0.25)
    np.testing.assert_array_equal(c1[:, 0], c0[:, 0])


def _assert_int4_robust(got, want):
    s1, c1, _ = got
    s0, c0, _ = want
    np.testing.assert_array_equal(c1[:, 0], c0[:, 0])
    for b in range(s0.shape[0]):
        set0 = {tuple(r) for r, sc in zip(c0[b], s0[b]) if sc > -1e29}
        set1 = {tuple(r) for r, sc in zip(c1[b], s1[b]) if sc > -1e29}
        assert len(set0 & set1) >= min(len(set0), len(set1)) - 1, \
            (b, set0, set1)


@pytest.mark.parametrize("against", ["megarow", "xla"])
def test_int4_cache_retrieval_robust(world, against):
    _assert_int4_robust(_port(world, "int4"),
                        _jax_megarow(world, "int4") if against == "megarow"
                        else world["xla"])


@pytest.mark.parametrize("against", ["megarow", "xla"])
def test_exact_cache_matches_jax_at_1024_codes(world_1024, against):
    w = world_1024
    assert w["tables"].unique_codes.dtype == torch.int16
    got = _port(w, None)
    assert int(got[1].max()) >= 256
    _assert_exact_parity(got, _jax_megarow(w, None) if against == "megarow"
                         else w["xla"])


def test_int4_cache_retrieval_robust_at_1024_codes(world_1024):
    """Held to the JAX package's int4 megarow search: here the int4 cache
    moves the JAX package's own top beam of the first query away from its
    XLA path's (exact scores 34.75 and 33.65, int4 errors near 1)."""
    w = world_1024
    _assert_int4_robust(_port(w, "int4"), _jax_megarow(w, "int4"))


def test_unconstrained_search_runs():
    # beam_search decodes with 4 cache segments: M=8 gives even spans
    cfg, params, ids, mask, _ = setup(M=8, K=8)
    out = beam_search(cfg, port_state_dict(params, cfg), ids, mask,
                      trie=None, num_beams=4, dtype=torch.float32,
                      device="cpu")
    assert out.codes.shape == (2, 4, cfg.M)
    assert (out.scores > -1e29).all()
    assert (out.groups == -1).all()
    assert (np.diff(out.scores, axis=1) <= 1e-5).all()


def test_beam_outputs_are_valid_smtids_and_expand_like_jax():
    cfg, params, ids, mask, doc_codes = setup(M=8, K=4, n_docs=50)
    trie = build_trie(doc_codes, 4)
    out = beam_search(cfg, port_state_dict(params, cfg), ids, mask,
                      trie=trie, num_beams=BEAMS, dtype=torch.float32,
                      device="cpu")
    valid = {tuple(r) for r in trie.unique_codes.tolist()}
    for b in range(out.codes.shape[0]):
        assert out.scores[b, 0] > -1e29
        for n in range(BEAMS):
            if out.scores[b, n] > -1e29:
                assert tuple(out.codes[b, n].tolist()) in valid
                np.testing.assert_array_equal(
                    trie.unique_codes[out.groups[b, n]], out.codes[b, n])
        docs, scores = expand_groups_to_docids(trie, out.groups[b],
                                               out.scores[b], topk=7)
        jdocs, jscores = jax_expand(trie, out.groups[b], out.scores[b],
                                    topk=7)
        assert 0 < len(docs) <= 7 and (np.diff(scores) <= 1e-5).all()
        np.testing.assert_array_equal(docs, jdocs)
        np.testing.assert_array_equal(scores, jscores)


def test_write_attend_beam_search_matches_oracle():
    """The port's beam_search on the write-then-attend path against the
    JAX package's slow oracle (a full teacher-forced forward per step and
    a dict trie; tests/test_beam.py::test_beam_search_matches_oracle), at
    that test's bars: scores within rtol 1e-4, equal sets up to ties."""
    from test_beam import oracle_beam_search
    from test_beam import setup as oracle_setup
    cfg, jmodel, params, ids, mask, doc_codes, _ = oracle_setup()
    num_beams = 4
    out = beam_search(cfg, port_state_dict(params, cfg), np.array(ids),
                      np.array(mask), trie=build_trie(doc_codes, cfg.K),
                      num_beams=num_beams, dtype=torch.float32,
                      device="cpu", use_pallas_gather=False)
    oracle = oracle_beam_search(cfg, jmodel, params, ids, mask, doc_codes,
                                num_beams)
    for b in range(ids.shape[0]):
        got = [(tuple(out.codes[b, n].tolist()), out.scores[b, n])
               for n in range(num_beams) if out.scores[b, n] > -1e29]
        want = oracle[b]
        assert len(got) == len(want)
        for (_, gs), (_, ws) in zip(got, want):
            np.testing.assert_allclose(gs, ws, rtol=1e-4, atol=1e-4)
        got_set = {gc for gc, _ in got}
        want_set = {wc for wc, _ in want}
        assert got_set == want_set or np.allclose(
            sorted(s for _, s in got), sorted(s for _, s in want), rtol=1e-4)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(kv_cache_quant="int2"), ValueError),
    (dict(megarow=True, deferred=False), ValueError),
    (dict(megarow=True, cache_segments=4), ValueError),  # M=6: odd spans
    # odd spans take the non-deferred path, which holds exact caches only
    (dict(cache_segments=4, kv_cache_quant="int8"), ValueError),
    (dict(kvg_quant_xla=True), ValueError),
    # ffn_int8 runs on the megarow and deferred paths only
    (dict(ffn_int8=True, deferred=False), ValueError),
    # the deferred path's kvg_quant_xla is for int8 caches only
    (dict(megarow=False, kv_cache_quant="int4", kvg_quant_xla=True),
     ValueError),
    (dict(deferred=False, kv_cache_quant="int8"), ValueError),
])
def test_refuses_what_the_reference_refuses(world, kwargs, exc):
    """Arguments are validated as the reference validates them."""
    args = dict(constrained=True, dtype=torch.float32, cache_segments=3,
                device="cpu")
    args.update(kwargs)
    with pytest.raises(exc):
        make_beam_search_fn(world["cfg"], BEAMS, **args)
