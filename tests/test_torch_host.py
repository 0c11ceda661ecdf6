"""The port's host modules against the JAX package's on the same inputs:
datasets, the trec metrics (Python and native routes), the quant gate,
checkpoints (params.pt, and the JAX package's Orbax trees), the native
trie builder, the tokenizer files, and the int8-weight FFN (its apply at
tests/test_beam.py:622-644's bar, and ffn_int8 searches at :646-672's)."""
import dataclasses
import json
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ripor_tpu.data.datasets as jds
import ripor_tpu.decode.quant_gate as jqg
import ripor_tpu.evaluation.metrics as jmetrics
import ripor_tpu.native_ext as jnative
import ripor_tpu_torch.data.datasets as pds
import ripor_tpu_torch.decode.quant_gate as pqg
import ripor_tpu_torch.evaluation.metrics as pmetrics
import ripor_tpu_torch.native_ext as pnative
from ripor_tpu.data import UnigramTokenizer as JaxUnigramTokenizer
from ripor_tpu.data import WordTokenizer as JaxWordTokenizer
from ripor_tpu.decode.beam import make_beam_search_fn as jax_beam_fn
from ripor_tpu.models import ripor_small as jax_ripor_small
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.ops.int8_ffn import ffn_int8_apply as jax_ffn_int8_apply
from ripor_tpu.ops.int8_ffn import quantize_ffn as jax_quantize_ffn
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu.trie import succinct_tables as jax_succinct_tables
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
from ripor_tpu_torch.evaluation import retrieve_to_run
from ripor_tpu_torch.models import (RiporConfig, RiporModel, init_params,
                                    params_from_jax, ripor_small)
from ripor_tpu_torch.ops.int8_ffn import ffn_int8_apply, quantize_ffn
from ripor_tpu_torch.pipeline import Workspace, load_tokenizer, stage_retrieve
from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
from ripor_tpu_torch.train import load_params, save_params
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch
from torch_parity import port_model, port_state_dict, setup

# ---- datasets -------------------------------------------------------------


def test_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "raw.tsv").write_text(
        "".join(f"id{i}\ttext {i}\twith a tab\n" for i in range(7)) + "\n")
    for mod_a, mod_b in ((pds, jds), (jds, pds)):
        a, b = mod_a.Collection(tmp_path), mod_b.Collection(tmp_path)
        assert (a.ids, a.texts) == (b.ids, b.texts) and len(a) == 7
        assert a["id3"] == b["id3"] == "text 3\twith a tab"
        for r in range(3):
            sa, sb = a.shard(r, 3), b.shard(r, 3)
            assert (sa.ids, sa.texts) == (sb.ids, sb.texts)
            assert [sa[i] for i in sa.ids] == sa.texts
    codes = rng.integers(0, 16, (9, 5))
    docids = [f"d{i}" for i in range(9)]
    pds.save_docid_to_smtid(tmp_path / "p.json", docids, codes)
    jds.save_docid_to_smtid(tmp_path / "j.json", docids, codes)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    (pd, pc), (jd, jc) = (pds.load_docid_to_smtid(tmp_path / "p.json"),
                          jds.load_docid_to_smtid(tmp_path / "p.json"))
    assert pd == jd == docids
    np.testing.assert_array_equal(pc, jc)
    assert pc.dtype == jc.dtype == np.int32
    assert pds.smtid_to_str(codes[0]) == jds.smtid_to_str(codes[0])
    assert pds.parse_smtid_str("3_0_12") == jds.parse_smtid_str("3_0_12")

    ex = [{"qid": i, "docids": [f"d{j}" for j in range(5)],
           "scores": list(rng.standard_normal(5)),
           "smtid_4_scores": list(rng.standard_normal(5))} for i in range(4)]
    (tmp_path / "ex.jsonl").write_text("".join(json.dumps(e) + "\n"
                                               for e in ex))
    pe = pds.TeacherScoreExamples(tmp_path / "ex.jsonl")
    je = jds.TeacherScoreExamples(tmp_path / "ex.jsonl")
    assert pe.prefix_lengths_present() == je.prefix_lengths_present() == (4,)
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(4):
        assert pe.sample_pair(i, r1, (4,)) == je.sample_pair(i, r2, (4,))
    run = {f"q{i}": {f"d{j}": float(j) for j in range(8)} for i in range(3)}
    qrel = {"q0": {"d1": 1, "d2": 0}, "q2": {"d7": 2}, "q9": {"d1": 1}}
    assert (pds.build_bce_examples(qrel, run, neg_sample=3)
            == jds.build_bce_examples(qrel, run, neg_sample=3))
    (tmp_path / "qrel.json").write_text(json.dumps(qrel))
    assert pds.load_qrel(tmp_path / "qrel.json") == qrel


def test_tokenizer_files_of_the_jax_package(tmp_path):
    """load_tokenizer reads both kinds of file the JAX package saves and
    encodes as the JAX tokenizer does."""
    corpus = [f"document number {i} about subject {i % 7}" for i in range(30)]
    texts = ["subject 3 document", "unknown words here", ""]
    for name, tok in (("word", JaxWordTokenizer.train(corpus, 100)),
                      ("unigram", JaxUnigramTokenizer.train(corpus, 100))):
        path = tmp_path / f"{name}.json"
        tok.save(path)
        port = load_tokenizer(path)
        assert type(port).__name__ == type(tok).__name__
        for want, got in zip(tok.encode_batch(texts, 12),
                             port.encode_batch(texts, 12)):
            np.testing.assert_array_equal(got, want)


# ---- metrics --------------------------------------------------------------


def _random_run_qrel(seed, n_q=30, n_d=200, per_q=50, ties=True):
    """Runs (with score ties: rounded scores) and graded qrels, some
    queries unjudged and some judged but absent from the run."""
    rng = np.random.default_rng(seed)
    run, qrel = {}, {}
    for q in range(n_q):
        docs = rng.choice(n_d, per_q, replace=False)
        scores = rng.standard_normal(per_q)
        if ties:
            scores = np.round(scores, 1)
        run[f"q{q}"] = {f"d{d}": float(v) for d, v in zip(docs, scores)}
        if q % 5 == 4:
            continue
        rel = rng.choice(n_d, 3, replace=False)
        qrel[f"q{q}"] = {f"d{d}": int(rng.integers(0, 4)) for d in rel}
    qrel["q_absent"] = {"d1": 1}
    return run, qrel


METRICS = ["mrr_10", "mrr_100", "recall_10", "recall_100", "ndcg_cut_10",
           "ndcg_10", "recall", "ndcg_cut"]


@pytest.mark.parametrize("metric", METRICS)
def test_metrics_python_route_match_jax(metric):
    run, qrel = _random_run_qrel(0)
    assert (pmetrics.evaluate_run(run, qrel, metric)
            == jmetrics.evaluate_run(run, qrel, metric))


def test_metric_helpers_match_jax(tmp_path):
    run, qrel = _random_run_qrel(1)
    for fn in ("mrr_k", "recall_k", "ndcg_cut_k"):
        assert (getattr(pmetrics, fn)(run, qrel, 20, agg=False)
                == getattr(jmetrics, fn)(run, qrel, 20, agg=False))
    assert pmetrics.truncate_run(run, 7) == jmetrics.truncate_run(run, 7)
    assert pmetrics.binarize_qrel(qrel) == jmetrics.binarize_qrel(qrel)
    d2s = {f"d{d}": [-1, d % 3, d % 5, d % 7] for d in range(200)}
    for trunc in (0, 2):
        assert (pmetrics.qrel_to_smtid_qrel(d2s, qrel, trunc)
                == jmetrics.qrel_to_smtid_qrel(d2s, qrel, trunc))
    run_p = tmp_path / "run.json"
    run_p.write_text(json.dumps(run))
    for name in ("TREC_DL_qrel.json", "TREC_DL_qrel_binary.json",
                 "dev_qrel.json"):
        (tmp_path / name).write_text(json.dumps(qrel))
        for metric in ("mrr_10", "ndcg_cut_10"):
            args = (str(tmp_path / name), str(run_p), metric)
            try:
                want = jmetrics.load_and_evaluate(*args)
            except AssertionError:
                with pytest.raises(AssertionError):
                    pmetrics.load_and_evaluate(*args)
                continue
            assert pmetrics.load_and_evaluate(*args) == want
    scores = np.asarray([[0.5, 0.25], [0.75, 0.125]], np.float32)
    idx = np.asarray([[1, 0], [0, 2]])
    assert (retrieve_to_run(["a", "b"], ["x", "y", "z"], scores, idx)
            == {"a": {"y": 0.5, "x": 0.25}, "b": {"x": 0.75, "z": 0.125}})


@pytest.mark.parametrize("metric,k", [("mrr", 10), ("recall", 10),
                                      ("recall", 100), ("ndcg_cut", 10)])
def test_eval_metrics_native_matches_jax_and_python(metric, k):
    """Equal to the JAX package's native evaluator, ties included; equal
    to the Python route without ties (on tied scores the two routes of
    both packages cut the top k differently: the native one by docid, the
    Python truncate_run by insertion order)."""
    for ties in (True, False):
        run, qrel = _random_run_qrel(2, ties=ties)
        got = pnative.eval_metrics_native(run, qrel, metric, k)
        assert got is not None
        assert got == jnative.eval_metrics_native(run, qrel, metric, k)
    py = pmetrics.METRIC_FNS[metric](run, qrel, k)
    assert got == pytest.approx(py, abs=1e-9)


def test_evaluate_run_native_route_matches_jax():
    """Above 10^6 results evaluate_run takes the native evaluator in both
    packages (scores without ties, see above)."""
    rng = np.random.default_rng(3)
    docs = [f"d{d}" for d in range(1000)]
    run, qrel = {}, {}
    for q in range(1001):
        scores = rng.standard_normal(1000).tolist()
        run[f"q{q}"] = dict(zip(docs, scores))
        qrel[f"q{q}"] = {docs[int(d)]: 1 for d in rng.integers(0, 1000, 2)}
    assert sum(len(v) for v in run.values()) > 1_000_000
    got = pmetrics.evaluate_run(run, qrel, "mrr_10")
    assert got == jmetrics.evaluate_run(run, qrel, "mrr_10")
    assert got == pytest.approx(pmetrics.mrr_k(run, qrel, 10), abs=1e-9)


# ---- quant gate ------------------------------------------------------------


def test_quant_gate_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("RIPOR_UNVALIDATED_QUANT_OK", raising=False)
    for kv in (None, "int8", "int4"):
        for ffn in (False, True):
            assert pqg.quant_combo_key(kv, ffn) == jqg.quant_combo_key(kv, ffn)
    dirs = {m: tmp_path / m.__name__.split(".")[0] for m in (pqg, jqg)}
    (tmp_path / "scratch").mkdir()
    records = [("ffn_int8", 48, 47, 46, True, None),
               ("ffn_int8+int4kv", 48, 35, 27, True, None),
               ("ffn_int8+int8kv", 48, 40, 30, False, True),
               ("ffn_int8+int8kv", 0, 0, 0, True, None)]
    cases = [(None, False, None), ("int4", False, "d"), (None, True, None),
             (None, True, "d"), ("int4", True, "d"), ("int8", True, "d"),
             ("int8", True, "empty")]

    def outcome(mod, kv, ffn, where):
        ckpt = {None: None, "d": str(dirs[mod]),
                "empty": str(tmp_path / "empty")}[where]
        try:
            mod.ensure_quant_validated(kv, ffn, ckpt_dir=ckpt)
            return "ok"
        except ValueError as e:
            return str(e).split(".")[0]         # the reason, not the advice

    for rec in [None] + records:
        if rec is not None:
            for mod, d in dirs.items():
                d.mkdir(exist_ok=True)
                assert (mod.record_quant_validation(str(d), *rec)
                        == jqg.record_quant_validation(
                            str(tmp_path / "scratch"), *rec))
        for mod_case in cases:
            got = outcome(pqg, *mod_case).replace(str(dirs[pqg]), "D")
            want = outcome(jqg, *mod_case).replace(str(dirs[jqg]), "D")
            assert got == want, (rec, mod_case)
    assert ((dirs[pqg] / pqg.VALIDATION_FILE).read_text()
            == (dirs[jqg] / jqg.VALIDATION_FILE).read_text())


def test_preflight_refuses_unvalidated_ffn_int8(tmp_path):
    """RetrievalEngine and stage_retrieve refuse an ffn_int8 combination
    without an accepted record in ckpt_dir, before touching the model."""
    cfg = ripor_small(M=4, K=8)
    codes = np.random.default_rng(0).integers(0, 8, (20, 4))
    trie, docids = build_trie(codes, 8), [f"d{i}" for i in range(20)]
    scfg = ServeConfig(num_beams=4, topk=5, batch_sizes=(2,),
                       kv_cache_quant="int4", ffn_int8=True,
                       ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="quant preflight"):
        RetrievalEngine(cfg, {}, None, trie, docids, scfg, warm=False,
                        device="cpu")
    with pytest.raises(ValueError, match="quant preflight"):
        stage_retrieve(Workspace(tmp_path / "ws"), cfg, None, None, None,
                       trie, docids, ffn_int8=True, ckpt_dir=str(tmp_path))


# ---- checkpoints -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """An Orbax checkpoint written by ripor_tpu.train.save_params."""
    cfg = jax_ripor_small(M=4, K=8)
    params = init_ripor_params(jax.random.PRNGKey(3), cfg)
    path = tmp_path_factory.mktemp("orbax") / "ckpt"
    jax_save_params(path, params, cfg)
    return path, cfg, params


def test_load_params_reads_orbax_bit_equal(jax_ckpt):
    path, jcfg, params = jax_ckpt
    cfg = RiporConfig.load(path / "config.json")
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg)
    for got in (load_params(path), load_params(path, cfg)):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_params_pt_round_trip_and_precedence(jax_ckpt, tmp_path):
    path, _, _ = jax_ckpt
    cfg = RiporConfig.load(path / "config.json")
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    save_params(tmp_path / "c", sd, cfg)
    assert RiporConfig.load(tmp_path / "c/config.json") == cfg
    got = load_params(tmp_path / "c")
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) and got[k].dtype == sd[k].dtype
               for k in sd)
    # conversion of a JAX checkpoint next to its Orbax tree: params.pt is
    # read first
    shutil.copytree(path, tmp_path / "j")
    save_params(tmp_path / "j", sd)
    assert all(torch.equal(load_params(tmp_path / "j")[k], sd[k]) for k in sd)
    with pytest.raises(FileNotFoundError):
        load_params(tmp_path / "nothing")


def test_orbax_without_tensorstore_names_the_remedy(jax_ckpt, monkeypatch):
    path, _, _ = jax_ckpt
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="tensorstore") as e:
        load_params(path)
    assert "save_params(dir, load_params(dir), cfg)" in str(e.value)


# ---- native trie -----------------------------------------------------------


@pytest.mark.parametrize("n,M,K,seed", [(500, 6, 16, 0), (3000, 8, 32, 1)])
def test_native_trie_matches_jax_and_numpy(n, M, K, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, K, (n // 2, M))
    codes = base[rng.integers(0, len(base), n)]        # with duplicates
    assert pnative.native_available()
    tries = [build_trie(codes, K, use_native=True),
             build_trie(codes, K, use_native=False),
             jax_build_trie(codes, K, use_native=True),
             jax_build_trie(codes, K, use_native=False)]
    for t in tries[1:]:
        for a in ("children", "unique_codes", "group_doc_offsets",
                  "group_docids"):
            np.testing.assert_array_equal(getattr(tries[0], a),
                                          getattr(t, a))


def test_build_trie_takes_native_above_200k(monkeypatch):
    calls = []
    real = pnative.trie_build_native

    def spy(codes, K):
        calls.append(len(codes))
        return real(codes, K)

    monkeypatch.setattr(pnative, "trie_build_native", spy)
    codes = np.random.default_rng(0).integers(0, 4, (200_001, 3))
    big = build_trie(codes, 4)
    assert calls == [200_001]
    build_trie(codes[:200_000], 4)
    assert calls == [200_001]
    np.testing.assert_array_equal(
        big.group_docids, build_trie(codes, 4, use_native=False).group_docids)


# ---- int8-weight FFN ---------------------------------------------------------


def test_ffn_int8_matches_jax():
    """quantize_ffn bit-equal to the JAX package's; ffn_int8_apply within
    3 % of the output's max of the JAX function and of the exact FFN
    (tests/test_beam.py:622-644's bar)."""
    cfg, params, *_ = setup(M=4, K=8)
    L = cfg.t5.num_decoder_layers
    want_q = [np.asarray(a) for a in jax_quantize_ffn(params, L)]
    got_q = quantize_ffn(port_state_dict(params, cfg), L)
    for g, w in zip(got_q, want_q):
        assert g.shape == w.shape and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    h = np.random.default_rng(1).standard_normal((3, 5, cfg.t5.d_model))
    h = h.astype(np.float32)
    for l in range(L):
        ffn = params["decoder"][f"layer_{l}"]["ffn"]
        wi = np.asarray(ffn["wi"]["kernel"], np.float32)
        wo = np.asarray(ffn["wo"]["kernel"], np.float32)
        exact = np.maximum(h.reshape(-1, wi.shape[0]) @ wi, 0) @ wo
        want = np.asarray(jax_ffn_int8_apply(
            jnp.asarray(h), *(jnp.asarray(a[l]) for a in want_q)))
        got = ffn_int8_apply(torch.from_numpy(h), *(a[l] for a in got_q))
        assert got.dtype == torch.float32 and got.shape == h.shape
        got = got.numpy().reshape(exact.shape)
        for ref in (want.reshape(exact.shape), exact):
            denom = max(np.abs(ref).max(), 1e-6)
            assert np.abs(got - ref).max() / denom < 0.03, l
        got16 = ffn_int8_apply(torch.from_numpy(h).bfloat16(),
                               *(a[l] for a in got_q))
        assert got16.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def ffn_world():
    """tests/test_beam.py:646-672's set-up: M=6, K=8, 40 docs, 5 beams,
    and the JAX package's exact path (XLA, deferred=False, f32)."""
    cfg, params, ids, mask, doc_codes = setup(M=6, K=8, n_docs=40)
    trie = jax_build_trie(doc_codes, 8)
    ref = jax_beam_fn(cfg, 5, constrained=True, dtype=jnp.float32,
                      use_pallas_gather=False, deferred=False)
    s0, c0, _ = ref(params, jnp.asarray(ids), jnp.asarray(mask),
                    jax.tree.map(jnp.asarray, jax_succinct_tables(trie)))
    return dict(cfg=cfg, params=params, ids=ids, mask=mask,
                doc_codes=doc_codes, s0=np.asarray(s0), c0=np.asarray(c0))


@pytest.mark.parametrize("path", [dict(megarow=True), dict(megarow=False)])
def test_ffn_int8_search_at_the_reference_bar(ffn_world, path):
    """The ffn_int8 search on the megarow and deferred paths against the
    exact path: top beam equal, live scores within rtol 0.05 / atol 0.25,
    code sets differing by at most one."""
    w = ffn_world
    cfg = w["cfg"]
    fn = make_beam_search_fn(cfg, 5, constrained=True, dtype=torch.float32,
                             cache_segments=3, ffn_int8=True, device="cpu",
                             **path)
    tables = tables_to_torch(succinct_tables(build_trie(w["doc_codes"], 8)),
                             "cpu")
    s1, c1, _ = (a.numpy() for a in fn(port_model(w["params"], cfg), w["ids"],
                                        w["mask"], tables))
    s0, c0 = w["s0"], w["c0"]
    np.testing.assert_array_equal(c0[:, 0], c1[:, 0])
    live = s0 > NEG_INF / 2
    np.testing.assert_allclose(s1[live], s0[live], rtol=0.05, atol=0.25)
    assert not np.allclose(s1[live], s0[live], rtol=1e-6, atol=1e-6)
    for b in range(s0.shape[0]):
        set0 = {tuple(r) for r, sc in zip(c0[b], s0[b]) if sc > NEG_INF / 2}
        set1 = {tuple(r) for r, sc in zip(c1[b], s1[b]) if sc > NEG_INF / 2}
        assert len(set0 & set1) >= min(len(set0), len(set1)) - 1


def test_ffn_int8_runs_through_the_entry_points(tmp_path):
    """stage_retrieve with ffn_int8 and an accepted record runs on the
    deferred/megarow path; a gated FFN is refused as in the reference."""
    cfg = ripor_small(M=8, K=8)
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    codes = np.random.default_rng(0).integers(0, 8, (20, 8))
    pqg.record_quant_validation(str(tmp_path), "ffn_int8", 8, 8, 8, True)
    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(sd)
    (tmp_path / "q.tsv").write_text("q0\tone\nq1\ttwo words\n")
    run = stage_retrieve(Workspace(tmp_path / "ws"), cfg, model,
                         HashTokenizer(100), pds.Collection(tmp_path / "q.tsv"),
                         build_trie(codes, 8), [f"d{i}" for i in range(20)],
                         num_beams=4, topk=4, ffn_int8=True,
                         ckpt_dir=str(tmp_path))
    assert list(run) == ["q0", "q1"] and all(len(v) == 4 for v in run.values())
    gated = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, feed_forward_proj="gated-gelu"))
    with pytest.raises(ValueError, match="non-gated"):
        make_beam_search_fn(gated, 4, ffn_int8=True, device="cpu")
