"""The port's dense retrieval (evaluation/retriever.py, serve/engine.py's
DenseEngine) and dev evaluation (evaluation/dev_eval.py) against the JAX
package, on the CPU.

dense_topk is held on every route (numpy blocks merged on the host, the
corpus-tensor scan with its clamped tail block, the int8 corpus) on data
without tied scores: indices equal, scores within rtol 1e-5 (f32 sums in
another order). Int8Corpus codes and scales are bit-equal. Model outputs
are held at tests/test_torch_model.py's f32 bar (1e-5); the bf16 engines
at tests/test_torch_engine.py's (top-1 equal, scores within rtol 2e-2 of
the query's score scale); dev_eval's metrics and first_smtid equal in f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from ripor_tpu.evaluation import dev_eval as jax_dev
from ripor_tpu.evaluation import retriever as jax_ret
from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.serve import DenseEngine as JaxDenseEngine
from ripor_tpu.serve import ServeConfig as JaxServeConfig
from ripor_tpu_torch.data.tokenizer import HashTokenizer, tokenize_queries
from ripor_tpu_torch.evaluation import dev_eval, retriever
from ripor_tpu_torch.serve import DenseEngine, ServeConfig
from torch_parity import port_model, port_state_dict, setup

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)


def data(n, d=16, q=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def assert_same_topk(got, want, rtol=1e-5):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=rtol)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int64


def test_dense_topk_host_blocks_match_jax():
    q, d = data(1000)
    got = retriever.dense_topk(q, d, 20, block_docs=300, device=CPU)
    assert_same_topk(got, jax_ret.dense_topk(q, d, 20, block_docs=300))
    brute = q @ d.T
    np.testing.assert_array_equal(got[1], np.argsort(-brute, 1)[:, :20])


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_dense_topk_device_scan_matches_jax(dtype, jdtype):
    # 1001 docs in blocks of at most 300: 4 blocks of 256, the last
    # starting at 745, so 23 rows are scored twice and must count once
    q, d = data(1001, seed=1)
    corpus = retriever.device_corpus(d, dtype=dtype, device=CPU)
    assert corpus.dtype == dtype and corpus.device.type == "cpu"
    got = retriever.dense_topk(q, corpus, 40, block_docs=300)
    assert all(len(set(r)) == 40 for r in got[1].tolist())
    assert_same_topk(got, jax_ret.dense_topk(
        q, jax_ret.device_corpus(d, dtype=jdtype), 40, block_docs=300))
    # docs in the tail block's overlap (rows 747-752), made the
    # best match of their own queries: each is found once, first
    tail = np.arange(747, 753)
    d[tail] *= 4.0
    corpus = retriever.device_corpus(d, dtype=dtype, device=CPU)
    s, i = retriever.dense_topk(d[tail], corpus, 3, block_docs=300)
    np.testing.assert_array_equal(i[:, 0], tail)
    assert all(len(set(r)) == 3 for r in i.tolist())
    assert_same_topk((s, i), jax_ret.dense_topk(
        d[tail], jax_ret.device_corpus(d, dtype=jdtype), 3, block_docs=300))


def test_dense_topk_approx_is_exact():
    q, d = data(600, seed=2)
    corpus = retriever.device_corpus(d, device=CPU)
    exact = retriever.dense_topk(q, corpus, 10)
    approx = retriever.dense_topk(q, corpus, 10, approx=True)
    np.testing.assert_array_equal(approx[1], exact[1])
    np.testing.assert_array_equal(approx[0], exact[0])


def test_int8_corpus_bit_equal_and_topk_match_jax():
    q, d = data(600, d=32, q=6, seed=9)
    want = jax_ret.device_corpus(d, dtype=jnp.int8, chunk=250)
    got = retriever.device_corpus(d, dtype=torch.int8, chunk=250, device=CPU)
    assert isinstance(got, retriever.Int8Corpus)
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    # quantized where a tensor lies: the same bits
    on_t = retriever.device_corpus(torch.tensor(d), dtype=torch.int8,
                                   chunk=250)
    assert torch.equal(on_t.codes, got.codes)
    assert torch.equal(on_t.scale, got.scale)
    res = retriever.dense_topk(q, got, 10, block_docs=250)
    assert_same_topk(res, jax_ret.dense_topk(q, want, 10, block_docs=250))
    # tests/test_eval.py's bar against exact f32 MIPS
    brute = q @ d.T
    want_i = np.argsort(-brute, axis=1)[:, :10]
    np.testing.assert_array_equal(res[1][:, 0], want_i[:, 0])
    overlap = np.mean([len(set(a) & set(b)) / 10.0
                       for a, b in zip(res[1], want_i)])
    assert overlap >= 0.9, overlap
    np.testing.assert_allclose(res[0], np.take_along_axis(brute, res[1], 1),
                               rtol=0.05, atol=0.05)


def test_mesh_refused():
    """An Int8Corpus (the single-card capacity path) is refused on a mesh,
    before the mesh is read; a dense corpus on a mesh:
    tests/test_torch_mesh.py."""
    q, d = data(64)
    with pytest.raises(NotImplementedError, match="Int8Corpus"):
        retriever.dense_topk(q, retriever.device_corpus(
            d, dtype=torch.int8, device=CPU), 5, mesh=object())


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    q, d = data(64)
    for call in (lambda: retriever.dense_topk(q, d, 5),
                 lambda: retriever.device_corpus(d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.fixture(scope="module")
def world():
    cfg, params, ids, mask, _ = setup(M=4, K=8, batch=4, seed=3)
    return cfg, params, ids, mask


def test_encode_corpus_matches_jax(world):
    cfg, params, ids, mask = world
    batches = [{"input_ids": ids, "attention_mask": mask, "n_valid": 3},
               {"input_ids": ids[::-1].copy(), "attention_mask": mask}]
    want = jax_ret.encode_corpus(JaxRiporModel(cfg), params, batches)
    got = retriever.encode_corpus(port_model(params, cfg), batches)
    assert got.shape == want.shape == (7, cfg.t5.d_model)
    np.testing.assert_allclose(got, want, **TOL)


def test_aq_flat_search_matches_jax():
    rng = np.random.default_rng(4)
    books = rng.standard_normal((3, 64, 16)).astype(np.float32)
    # distinct codes, so no two reconstructions tie
    codes = np.unique(rng.integers(0, 64, (200, 3)), axis=0)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    assert_same_topk(
        retriever.aq_flat_search(q, books, codes, 12, device=CPU),
        jax_ret.aq_flat_search(q, books, codes, 12))


QUERIES = ["what is jax", "tpu systolic array", "residual quantization",
           "beam search", "semantic ids"]


def test_dense_engine_matches_jax_engine(world):
    cfg, params, *_ = world
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((300, cfg.t5.d_model)).astype(np.float32)
    docids = [f"d{i}" for i in range(300)]
    kw = dict(topk=9, max_length=8, batch_sizes=(1, 2, 4))
    ref = JaxDenseEngine(cfg, jax.tree.map(np.asarray, params),
                         JaxHashTokenizer(100),
                         jax_ret.device_corpus(corpus), docids,
                         JaxServeConfig(**kw))
    sd = port_state_dict(params, cfg)
    port = DenseEngine(cfg, sd, HashTokenizer(100), corpus, docids,
                       ServeConfig(**kw), device=CPU)
    assert port._corpus.dtype == torch.bfloat16
    got, want = port.retrieve_batch(QUERIES), ref.retrieve_batch(QUERIES)
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 9 and g[0][0] == w[0][0]
        scale = max(abs(s) for _, s in w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=2e-2, atol=2e-2 * scale)
        ss = [s for _, s in g]
        assert ss == sorted(ss, reverse=True)
    # in f32 over an f32 corpus tensor the engine is dense_rep + dense_topk
    # (tests/test_serve.py::test_dense_engine_matches_dense_topk)
    eng = DenseEngine(cfg, sd, HashTokenizer(100),
                      torch.tensor(corpus), docids,
                      ServeConfig(topk=5, max_length=6, batch_sizes=(2,)),
                      dtype=torch.float32, device=CPU)
    res = eng.retrieve_batch(QUERIES[:2])
    qi, qm = tokenize_queries(HashTokenizer(100), QUERIES[:2], 6)
    with torch.inference_mode():
        reps = port_model(params, cfg).dense_rep(torch.as_tensor(qi),
                                                 torch.as_tensor(qm))
    s, i = retriever.dense_topk(reps.numpy(), torch.tensor(corpus), 5)
    for b in range(2):
        assert [d for d, _ in res[b]] == [docids[d] for d in i[b]]
        np.testing.assert_allclose([v for _, v in res[b]], s[b], rtol=1e-5)


def test_dev_eval_and_first_smtid_match_jax(world):
    cfg, params, ids, mask = world
    model = port_model(params, cfg)
    want_first = jax_dev.first_smtid(cfg, params, ids, mask)
    got_first = dev_eval.first_smtid(cfg, model, ids, mask)
    assert got_first.dtype == np.int32
    np.testing.assert_array_equal(got_first, want_first)
    # targets that hit at several ranks: beams of the JAX package's own
    # unconstrained search, single and multi-positive
    from ripor_tpu.decode.beam import make_beam_search_fn as jax_beam_fn
    from ripor_tpu.trie.succinct import dummy_tables as jax_dummy
    _, codes, _ = jax_beam_fn(cfg, 5, constrained=False, dtype=jnp.float32)(
        params, jnp.asarray(ids), jnp.asarray(mask),
        jax.tree.map(jnp.asarray, jax_dummy(cfg.M)))
    codes = np.asarray(codes)
    miss = np.full(cfg.M, cfg.K - 1)
    targets = [codes[0, 2], np.stack([codes[1, 0], miss, codes[1, 4]]),
               miss[None], np.stack([codes[3, 1], codes[3, 3]])]
    batches = [(ids[:2], mask[:2]), (ids[2:], mask[2:])]
    want = jax_dev.dev_eval(cfg, params, batches, targets, num_beams=5)
    got = dev_eval.dev_eval(cfg, model, batches, targets, num_beams=5)
    assert got == want
    assert 0 < got["dev_mrr_10"] < 1 and 0 < got["dev_recall_10"] < 1
