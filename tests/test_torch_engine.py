"""The port's RetrievalEngine against the JAX package's, on a toy model
with HashTokenizer and an exact cache. Both decode in bfloat16
(ServeConfig.param_dtype), and bf16 rounds at other places in the two
frameworks (and on the CPU the JAX engine takes its XLA path, which
attends in f32 where megarow forms bf16 products), so: top-1 docid equal
per query, and scores within rtol 2e-2 of the query's score scale — a
beam score is a sum of M logits, and bf16 error scales with the logits'
magnitude (the largest score), not with a sum that may cancel toward 0."""
import jax
import numpy as np
import pytest

from ripor_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from ripor_tpu.serve import RetrievalEngine as JaxRetrievalEngine
from ripor_tpu.serve import ServeConfig as JaxServeConfig
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
from ripor_tpu_torch.trie import build_trie
from torch_parity import port_state_dict, setup

QUERIES = ["what is jax", "tpu systolic array", "residual quantization",
           "beam search", "semantic ids", "msmarco passages"]
SERVE = dict(num_beams=5, topk=7, max_length=8, batch_sizes=(1, 2, 4),
             max_delay_ms=20.0)


@pytest.fixture(scope="module")
def engines():
    # M=8 with the default 4 cache segments gives the even spans the
    # megarow path needs
    cfg, params, _, _, doc_codes = setup(M=8, K=8, n_docs=60, seed=3)
    docids = [f"d{i}" for i in range(len(doc_codes))]
    port = RetrievalEngine(cfg, port_state_dict(params, cfg),
                           HashTokenizer(100), build_trie(doc_codes, 8),
                           docids, ServeConfig(**SERVE), device="cpu")
    ref = JaxRetrievalEngine(cfg, jax.tree.map(np.asarray, params),
                             JaxHashTokenizer(100),
                             jax_build_trie(doc_codes, 8), docids,
                             JaxServeConfig(**SERVE))
    return port, ref


def _assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g and w
        assert g[0][0] == w[0][0]                      # top-1 docid
        n = min(len(g), len(w))
        scale = max(abs(s) for _, s in w)
        np.testing.assert_allclose([s for _, s in g[:n]],
                                   [s for _, s in w[:n]], rtol=2e-2,
                                   atol=2e-2 * scale)
        ss = [s for _, s in g]
        assert ss == sorted(ss, reverse=True) and len(g) <= SERVE["topk"]


def test_retrieve_batch_matches_jax_engine(engines):
    port, ref = engines
    _assert_close(port.retrieve_batch(QUERIES), ref.retrieve_batch(QUERIES))


def test_submit_matches_retrieve_batch(engines):
    port, _ = engines
    want = port.retrieve_batch(QUERIES[:3])
    port.start()
    try:
        futs = [port.submit(q) for q in QUERIES[:3]]
        got = [f.result(timeout=60) for f in futs]
    finally:
        port.stop()
    assert not port._thread.is_alive()
    assert [[d for d, _ in r] for r in got] == [[d for d, _ in r]
                                                for r in want]
    assert port.stats()["served"] >= 6
