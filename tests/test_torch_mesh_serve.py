"""Serving on a mesh of more than one rank: ``RetrievalEngine(mesh=)``'s
``start``/``submit``/``stop`` and ``serve_http`` in one 4-rank gloo world
(data=2 x model=2, tests/torch_mesh_ranks.py's ``serve`` job): every rank
starts and stops, rank 0 alone takes requests and broadcasts each batch,
the other ranks follow it.

Bars: within the port, tests/test_serve.py:106-128's (docids equal,
scores rtol 1e-4) between the mesh engine's submit/HTTP answers, its
``retrieve_batch`` and the one-rank engine; against the JAX package's
``RetrievalEngine(mesh=mesh8)`` on the same params, tests/
test_torch_engine.py's cross-package bar (top-1 docid equal, scores
within rtol 2e-2 of the query's score scale): both engines decode in
bfloat16, which rounds at other places in the two frameworks."""
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from ripor_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from ripor_tpu.models import ripor_small as jax_ripor_small
from ripor_tpu.serve import RetrievalEngine as JaxRetrievalEngine
from ripor_tpu.serve import ServeConfig as JaxServeConfig
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.models import ripor_small
from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
from ripor_tpu_torch.trie import build_trie
from torch_parity import port_state_dict, seeded_params

QUERIES = ["what is jax", "tpu systolic array", "residual quantization",
           "beam search", "semantic ids", "msmarco passages"]
ENGINE = dict(num_beams=5, topk=7, max_length=6, max_delay_ms=50.0,
              param_dtype=None)


@pytest.fixture(scope="module")
def world(tmp_path_factory, mesh8):
    cfg = ripor_small(M=4, K=8)
    params = seeded_params(cfg, 7)
    sd = port_state_dict(params, cfg)
    doc_codes = np.random.default_rng(7).integers(0, 8, (40, 4))
    handle = ranks.start(
        "serve", {"engine": (cfg, sd, doc_codes, QUERIES,
                             dict(ENGINE, batch_sizes=(2, 4)))},
        tmp_path_factory.mktemp("serve"))
    # the references, while the ranks run
    docids = [f"d{i}" for i in range(len(doc_codes))]
    one = RetrievalEngine(cfg, sd, HashTokenizer(100),
                          build_trie(doc_codes, 8), docids,
                          ServeConfig(**ENGINE, batch_sizes=(1, 2, 4)),
                          device="cpu")
    want = {"one_rank": one.retrieve_batch(QUERIES)}
    jcfg = jax_ripor_small(M=4, K=8)
    jargs = (jcfg, params, JaxHashTokenizer(100),
             jax_build_trie(doc_codes, 8), docids)
    jax_mesh = JaxRetrievalEngine(*jargs, JaxServeConfig(
        **ENGINE, batch_sizes=(4,)), mesh=mesh8)
    want["jax_mesh"] = jax_mesh.retrieve_batch(QUERIES[:3])
    with pytest.raises(ValueError, match="data") as e:
        JaxRetrievalEngine(*jargs, JaxServeConfig(num_beams=5,
                                                  batch_sizes=(3,)),
                           warm=False, mesh=mesh8)
    want["jax_rung_error"] = str(e.value)
    return ranks.collect(handle), want


def _same(got, want, rtol=1e-4):
    """tests/test_serve.py:106-128's bar: docids equal, scores rtol."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [d for d, _ in g] == [d for d, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=rtol)


def _from_json(results):
    return [[(d, s) for d, s in r] for r in results]


def test_submit_and_http_equal_retrieve_batch(world):
    got, _ = world
    first = got[0]
    _same(first["submit"], first["retrieve_all"])
    for (status, body), q in zip(first["http_single"], QUERIES):
        assert status == 200
        _same(_from_json(body["results"]),
              first["retrieve_all"][QUERIES.index(q):][:1])
    status, body = first["http_batch"]
    assert status == 200
    _same(_from_json(body["results"]), first["retrieve_all"][:3])
    # the microbatcher coalesced the queued requests; stats are rank 0's
    assert first["stats"]["served"] >= len(QUERIES) + 6
    assert any(r > 2 for r in first["stats"]["batch_hist"])


def test_mesh_engine_matches_jax_and_one_rank(world):
    got, want = world
    for out in got:
        assert out["retrieve"] == got[0]["retrieve"]
        assert out["retrieve_all"] == got[0]["retrieve_all"]
        _same(out["retrieve_all"], want["one_rank"])
        assert "data" in out["rung_error"]
    for g, w in zip(got[0]["retrieve"], want["jax_mesh"]):
        assert g[0][0] == w[0][0]
        n = min(len(g), len(w))
        scale = max(abs(s) for _, s in w)
        np.testing.assert_allclose([s for _, s in g[:n]],
                                   [s for _, s in w[:n]], rtol=2e-2,
                                   atol=2e-2 * scale)
    assert "data" in want["jax_rung_error"]


def test_submit_only_on_the_first_rank(world):
    got, _ = world
    for r, out in enumerate(got):
        assert out["follows"] == (r > 0)
        assert out["server"] == (r == 0)
        if r:
            assert "first rank" in out["submit_error"]
            assert "submit" not in out


def test_stop_fails_queued_and_ends_the_followers(world):
    got, _ = world
    assert "stopped" in got[0]["orphan_error"]
    for out in got:
        assert out["threads_after_stop"] == []


def test_follower_exception_reaches_stop(world):
    got, _ = world
    assert got[1]["stop_error"] == "injected follower fault"
    _same(got[0]["after_fault"], got[0]["retrieve_all"][:2])
    # the fault never passes silently: the other ranks stop cleanly or
    # fail with the lost rank (once it exits, its sockets close)
    for r in (0, 2, 3):
        err = got[r]["stop_error"]
        assert err is None or "Connection closed" in err, err
