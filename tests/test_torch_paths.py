"""The port's deferred per-layer, non-deferred and write-then-attend
decode paths (plain kernel versions on the CPU) against the JAX package,
at the JAX package's own path-vs-path bars (tests/test_beam.py:126-145,
:312-345, :366-393), and the port's choice of path and refusals against
the reference's.

References: the JAX deferred path (K4 in interpret mode), the JAX
non-deferred kernel path (K5, K3 and K6 in interpret mode) and the JAX XLA
path (the write-then-attend path's own reference). Each JAX path runs
once, in a module-scoped fixture. Dead beams hold filler whose order is
not defined (torch.topk and lax.top_k break ties differently), so codes
and states are compared on live beams."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.decode.beam import make_beam_search_fn as jax_make
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu.trie.succinct import dummy_tables as jax_dummy_tables
from ripor_tpu.trie.succinct import succinct_tables as jax_tables
from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
from ripor_tpu_torch.ops import KERNEL_LAUNCHES
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch
from ripor_tpu_torch.trie.succinct import dummy_tables
from torch_parity import port_model, setup

BEAMS = 5


@pytest.fixture(scope="module")
def world():
    cfg, params, ids, mask, doc_codes = setup(M=6, K=8, n_docs=40)
    jtables = jax.tree.map(jnp.asarray,
                           jax_tables(jax_build_trie(doc_codes, 8)))
    tables = tables_to_torch(succinct_tables(build_trie(doc_codes, 8)),
                             "cpu")
    refs = {}

    def ref(name, constrained=True, **kw):
        if name not in refs:
            fn = jax_make(cfg, BEAMS, constrained=constrained,
                          dtype=jnp.float32, **kw)
            tabs = (jtables if constrained else jax.tree.map(
                jnp.asarray, jax_dummy_tables(cfg.M)))
            refs[name] = tuple(np.asarray(a) for a in fn(
                params, jnp.asarray(ids), jnp.asarray(mask), tabs))
        return refs[name]

    return dict(cfg=cfg, ids=ids, mask=mask, tables=tables, ref=ref,
                model=port_model(params, cfg))


def _xla(w):
    return w["ref"]("xla", use_pallas_gather=False, deferred=False)


def _port(w, constrained=True, **kw):
    fn = make_beam_search_fn(w["cfg"], BEAMS, constrained=constrained,
                             dtype=torch.float32, device="cpu", **kw)
    tables = (w["tables"] if constrained else
              tables_to_torch(dummy_tables(w["cfg"].M), "cpu"))
    return tuple(a.numpy() for a in fn(w["model"], w["ids"], w["mask"],
                                       tables))


def _assert_exact_parity(got, want):
    s1, c1, st1 = got
    s0, c0, st0 = want
    np.testing.assert_allclose(s1, s0, rtol=1e-5, atol=1e-5)
    live = s0 > NEG_INF / 2
    np.testing.assert_array_equal(live, s1 > NEG_INF / 2)
    np.testing.assert_array_equal(c1[live], c0[live])
    np.testing.assert_array_equal(st1[live], st0[live])


def test_deferred_exact_matches_jax_deferred(world):
    want = world["ref"]("deferred", use_pallas_gather=False, deferred=True,
                        cache_segments=3)
    _assert_exact_parity(_port(world, megarow=False, cache_segments=3),
                         want)


def test_deferred_exact_matches_jax_xla_path(world):
    _assert_exact_parity(_port(world, megarow=False, cache_segments=3),
                         _xla(world))


@pytest.mark.parametrize("kvg_xla", [False, True])
def test_deferred_int8_close_to_xla_path(world, kvg_xla):
    """Both kvg modes write the same int8 rows; with kvg_quant_xla slot t-1
    is also read quantized, hence the wider atol (the reference's bars)."""
    s1, c1, _ = _port(world, megarow=False, cache_segments=3,
                      kv_cache_quant="int8", kvg_quant_xla=kvg_xla)
    s0, c0, _ = _xla(world)
    live = s0 > NEG_INF / 2
    np.testing.assert_allclose(s1[live], s0[live], rtol=0.05,
                               atol=0.25 if kvg_xla else 0.05)
    np.testing.assert_array_equal(c1[:, 0], c0[:, 0])


def test_deferred_int4_retrieval_robust(world):
    s1, c1, _ = _port(world, megarow=False, cache_segments=3,
                      kv_cache_quant="int4")
    s0, c0, _ = _xla(world)
    np.testing.assert_array_equal(c1[:, 0], c0[:, 0])
    for b in range(s0.shape[0]):
        m0 = {tuple(r): sc for r, sc in zip(c0[b], s0[b]) if sc > -1e29}
        m1 = {tuple(r): sc for r, sc in zip(c1[b], s1[b]) if sc > -1e29}
        both = set(m0) & set(m1)
        assert len(both) >= min(len(m0), len(m1)) - 1, (b, m0, m1)
        for code in both:
            np.testing.assert_allclose(m1[code], m0[code], rtol=0.2,
                                       atol=0.6)


@pytest.mark.parametrize("kwargs", [dict(deferred=False),
                                    dict(cache_segments=4)])
def test_non_deferred_matches_jax_kernel_path(world, kwargs):
    """deferred=False, and the default at odd spans (M=6 over 4 segments:
    bounds 2/3/4/6), against the JAX non-deferred kernel path."""
    want = world["ref"]("non_deferred", use_pallas_gather=True,
                        deferred=False, megarow=False)
    _assert_exact_parity(_port(world, **kwargs), want)


def test_non_deferred_matches_jax_xla_path(world):
    _assert_exact_parity(_port(world, deferred=False), _xla(world))


@pytest.mark.parametrize("segments", [4, 3])
def test_write_attend_matches_jax_xla_path(world, segments):
    """use_pallas_gather=False at the default segments (M=6 over 4: odd
    spans 2/3/4/6) and at cache_segments=3 (even spans 2/4/6): the
    write-then-attend path either way, as in the reference."""
    _assert_exact_parity(_port(world, use_pallas_gather=False,
                               cache_segments=segments), _xla(world))


def test_write_attend_unconstrained_matches_jax(world):
    """constrained=False with dummy tables (tests/test_beam.py:396)."""
    want = world["ref"]("xla_unconstrained", constrained=False,
                        use_pallas_gather=False)
    got = _port(world, constrained=False, use_pallas_gather=False)
    assert (got[0] > NEG_INF / 2).all()
    _assert_exact_parity(got, want)


_PATH_ARGS = list(itertools.product((True, False), (None, True, False),
                                    (None, True, False), (None, "int8"),
                                    (3, 4)))


@pytest.mark.parametrize(
    "pallas,deferred,megarow,quant,segments", _PATH_ARGS,
    ids=["-".join(map(str, a)) for a in _PATH_ARGS])
def test_refuses_what_the_reference_refuses(world, pallas, deferred,
                                            megarow, quant, segments):
    """Over use_pallas_gather x deferred x megarow x kv_cache_quant, at
    even (3) and odd (4) segment spans for M=6: the port raises ValueError
    for exactly the calls the reference refuses."""
    kw = dict(use_pallas_gather=pallas, deferred=deferred, megarow=megarow,
              kv_cache_quant=quant, cache_segments=segments)

    def refused(make, **extra):
        try:
            make(world["cfg"], BEAMS, **kw, **extra)
        except ValueError:
            return True
        return False

    assert refused(make_beam_search_fn, dtype=torch.float32,
                   device="cpu") == refused(jax_make, dtype=jnp.float32)


def test_cpu_paths_launch_no_kernel(world):
    before = dict(KERNEL_LAUNCHES)
    _port(world, megarow=False, cache_segments=3, kv_cache_quant="int4")
    _port(world, deferred=False)
    _port(world, use_pallas_gather=False)
    assert KERNEL_LAUNCHES == before
