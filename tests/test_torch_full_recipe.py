"""The port's full 3-phase recipe (ripor_tpu_torch/pipeline/full_recipe.py)
on the CPU.

- Its stage helpers against the JAX package's on the same inputs:
  ``_stage_bm25_run`` (equal JSON), ``_teacher_quality``,
  ``_teacher_trainset``, ``_trainset_mrr`` and ``_pseudo_query_trainset``
  with the same deterministic stand-in teacher (equal files),
  ``_dense_run`` with the same toy params (same docs, scores within
  1e-5), ``stage_build_prefix_trie`` (equal tables).
- Plumbing: the port's ``run_full_recipe`` on tests/test_full_recipe.py's
  24-doc corpus with every epoch count at 1 (artifact names,
  checkpoints, trainset invariants, the ``prefix_eval`` keys), its resume
  through the CLI's ``full-recipe --device cpu`` (same metrics, no stage
  trains), the refresh gate's failure, and one run through the phase-3
  branches (teacher refresh, calibration, symmetric negatives, joint
  seq2seq, rehearsal, pseudo-rank, L2-SP).
- The floors: the port's recipe at tests/test_full_recipe.py::RECIPE_KW
  must reach the JAX test's own floors (marked ``slow``; its check on the
  card is chip_smoke.py phase 11 (c)). No test here runs the JAX
  package's whole recipe.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from ripor_tpu.data import Collection as JaxCollection
from ripor_tpu.data import HashTokenizer as JaxHashTokenizer
from ripor_tpu.data import build_bce_examples as jax_build_bce_examples
from ripor_tpu.data import save_bce_examples as jax_save_bce_examples
from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.pipeline import full_recipe as jax_fr
from ripor_tpu.pipeline.recipe import Workspace as JaxWorkspace
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data.datasets import Collection
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.pipeline import full_recipe as fr
from ripor_tpu_torch.pipeline.flywheel import read_jsonl
from ripor_tpu_torch.pipeline.recipe import Workspace
from test_full_recipe import RECIPE_KW, corpus  # noqa: F401 (fixture)
from torch_parity import port_model
from torch_parity import setup as parity_setup

EPOCH1 = dict(RECIPE_KW, phase1_epochs=1, teacher_epochs=1, s2s_epochs=1,
              mm_epochs=1, phase3_epochs=1)


def _det_pairs(pairs, query_texts=None):
    """A deterministic stand-in teacher over (qid, docid) pairs."""
    out = {}
    for q, d in pairs:
        out.setdefault(str(q), {})[str(d)] = float(
            (sum(map(ord, q)) * 31 + sum(map(ord, d)) * 7) % 53) / 5.0
    return out


def _det_score(ids, mask):
    """A deterministic stand-in teacher over encoded pairs."""
    return ((ids * mask).sum(axis=1) % 97).astype(np.float32) / 9.0


@pytest.fixture(scope="module")
def both(corpus, tmp_path_factory):
    """Both packages' workspaces and collections over the corpus."""
    tmp, docs_dir, queries_dir, qrel_path = corpus
    root = tmp_path_factory.mktemp("helpers")
    return dict(jws=JaxWorkspace(root / "jax"), ws=Workspace(root / "port"),
                jdocs=JaxCollection(docs_dir), jq=JaxCollection(queries_dir),
                docs=Collection(docs_dir), q=Collection(queries_dir),
                qrel=json.loads(Path(qrel_path).read_text()))


def _same_file(both, name):
    a = (both["ws"].root / name).read_bytes()
    assert a and a == (both["jws"].root / name).read_bytes(), name


def test_bm25_run_and_teacher_trainset_match_jax(both):
    run = fr._stage_bm25_run(both["ws"], both["q"], both["docs"], topk=10)
    want = jax_fr._stage_bm25_run(both["jws"], both["jq"], both["jdocs"],
                                  topk=10)
    assert run == want
    _same_file(both, "bm25_run.json")
    rel = _det_pairs([(q, d) for q, r in both["qrel"].items() for d in r])
    for mod, ws in ((fr, both["ws"]), (jax_fr, both["jws"])):
        mod._teacher_trainset(ws, "t0.jsonl", run, _det_pairs, rel,
                              top_k=6)
    _same_file(both, "t0.jsonl")
    rows = read_jsonl(str(both["ws"].path("t0.jsonl")))
    assert rows and all(len(r["docids"]) >= 2 for r in rows)
    got = fr._trainset_mrr(str(both["ws"].path("t0.jsonl")), both["qrel"])
    assert got == jax_fr._trainset_mrr(str(both["jws"].path("t0.jsonl")),
                                       both["qrel"])


def test_teacher_quality_and_pseudo_queries_match_jax(both):
    run = fr._stage_bm25_run(both["ws"], both["q"], both["docs"], topk=10)
    bce = both["ws"].root / "bce.tsv"
    jax_save_bce_examples(bce, jax_build_bce_examples(both["qrel"], run,
                                                      neg_sample=3, seed=0))
    tok, jtok = HashTokenizer(100), JaxHashTokenizer(100)
    for ws in (both["ws"], both["jws"]):     # the teacher's checkpoint dir
        (ws.root / "checkpoints/t").mkdir(parents=True)
    got = fr._teacher_quality(both["ws"], _det_score, tok, both["q"],
                              both["docs"], bce, stage="t")
    want = jax_fr._teacher_quality(both["jws"], _det_score, jtok, both["jq"],
                                   both["jdocs"], bce, stage="t")
    assert got == want and got["n_pos"] > 0 and got["n_neg"] > 0
    for mod, ws, docs, q in ((fr, both["ws"], both["docs"], both["q"]),
                             (jax_fr, both["jws"], both["jdocs"],
                              both["jq"])):
        mod._pseudo_query_trainset(ws, docs, q, both["qrel"], _det_pairs,
                                   per_doc=2, seed=3)
    _same_file(both, "query_to_docid.train.jsonl")


def test_dense_run_matches_jax(both):
    """The same toy params in both packages (f32): the same docs per
    query, scores within 1e-5."""
    cfg, params, _, _, _ = parity_setup(M=6, K=8)
    embs = np.random.default_rng(0).normal(
        size=(len(both["docs"]), cfg.t5.d_model)).astype(np.float32)
    args = (embs,)
    kw = dict(topk=5, batch_size=4)
    got = fr._dense_run(both["ws"], "dense.json", *args,
                        port_model(params, cfg), None, HashTokenizer(100),
                        both["q"], both["docs"].ids, **kw)
    want = jax_fr._dense_run(both["jws"], "dense.json", *args,
                             JaxRiporModel(cfg), params,
                             JaxHashTokenizer(100), both["jq"],
                             both["jdocs"].ids, **kw)
    assert list(got) == list(want)
    for qid, docs in want.items():
        assert set(got[qid]) == set(docs)
        np.testing.assert_allclose([got[qid][d] for d in docs],
                                   list(docs.values()), rtol=1e-5, atol=1e-5)
    assert json.loads(both["ws"].path("dense.json").read_text()) == got


def test_prefix_trie_and_helpers_match_jax(both):
    codes = np.random.default_rng(1).integers(0, 8, (30, 6))
    for plen in (2, 6):
        got = fr.stage_build_prefix_trie(both["ws"], codes, 8, plen)
        want = jax_fr.stage_build_prefix_trie(both["jws"], codes, 8, plen)
        name = f"trie_prefix{plen}.npz"
        g, w = (np.load(ws.path(name)) for ws in (both["ws"], both["jws"]))
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got.num_groups == want.num_groups
        # the port resumes from the JAX package's file
        (both["ws"].path(name)).write_bytes(both["jws"].path(name)
                                            .read_bytes())
        again = fr.stage_build_prefix_trie(both["ws"], codes, 8, plen)
        assert again.num_groups == want.num_groups
    for n, b, e in ((0, 8, 3), (17, 8, 2), (100, 16, 1)):
        assert fr._epochs_steps(n, b, e) == jax_fr._epochs_steps(n, b, e)
    over = fr._QueryOverlay(both["q"], {"pq0": "extra"})
    jover = jax_fr._QueryOverlay(both["jq"], {"pq0": "extra"})
    for qid in ("pq0", "q1"):
        assert over[qid] == jover[qid]


# ---- the port's whole recipe ----

ARTIFACTS = ("bm25_run.json", "pretrain_trainset_0.jsonl",
             "dense_run_phase1_0.json", "pretrain_trainset_1.jsonl",
             "dense_run_phase1_1.json", "phase2_mm_trainset.jsonl",
             "qid_to_reldocid_to_score.json", "query_to_docid.train.jsonl",
             "dense_run_phase2.json", "tokenizer.json",
             "docid_to_smtid.json", "codebooks.npy", "trie.npz",
             "run_phase2.json", "run_phase3.json", "perf_phase2.json",
             "perf_phase3.json", "bce_examples.train.tsv")
CHECKPOINTS = ("phase1_pretrain", "phase1_pretrain_1", "bert_teacher",
               "phase2_seq2seq", "phase2_margin_mse", "phase3_mnt_4",
               "phase3_mnt_8", "final")


def _recipe(corpus, ws, **kw):
    tmp, docs_dir, queries_dir, qrel_path = corpus
    return fr.run_full_recipe(
        workspace=str(ws), docs_dir=str(docs_dir),
        queries_dir=str(queries_dir), qrel_path=str(qrel_path),
        device="cpu", **{**EPOCH1, **kw})


@pytest.fixture(scope="module")
def plumbing(corpus):
    ws = corpus[0] / "torch_ws"
    kw = dict(calibrate_teacher_scale=True, prefix_eval=(4,))
    return ws, kw, _recipe(corpus, ws, **kw)


def test_full_recipe_plumbing(plumbing):
    ws, _, metrics = plumbing
    assert set(metrics) == {"phase2", "phase2_prefix4", "phase3",
                            "phase3_prefix4"}
    for m in metrics.values():
        assert set(m) == {"mrr_10", "recall_10", "recall_100"}
        assert all(np.isfinite(v) and 0 <= v <= 1 for v in m.values())
    for name in ARTIFACTS + ("trie_prefix4.npz",
                             "phase2_mm_trainset.cal.jsonl",
                             "calibration_phase2_mm.json",
                             "calibration_phase3_8.json",
                             "lng_knp_qid_smtids_scores_8.train.cal.json",
                             "checkpoints/bert_teacher/bert_geometry.json",
                             "checkpoints/bert_teacher/"
                             "teacher_quality.json"):
        assert (ws / name).exists(), name
    for name in CHECKPOINTS:
        assert (ws / "checkpoints" / name / "params.pt").exists(), name
    assert (ws / "checkpoints/final/config.json").exists()
    rows = read_jsonl(str(ws / "pretrain_trainset_0.jsonl"))
    assert rows
    for r in rows:
        assert len(r["docids"]) == len(r["scores"]) >= 2
        assert r["scores"][1:] == sorted(r["scores"][1:], reverse=True)
    for plen in (4, 8):
        examples = read_jsonl(
            str(ws / f"lng_knp_qid_smtids_scores_{plen}.train.json"))
        assert examples
        for ex in examples:
            assert len(ex["smtids"]) == len(ex["scores"])
            assert all(len(s.split("_")) == plen for s in ex["smtids"])
            assert ("smtid_4_scores" in ex) == (plen > 4)
        assert np.isfinite([s for ex in examples
                            for s in ex["scores"]]).all()
    alphas = json.loads((ws / "calibration_phase3_8.json").read_text())
    assert {"alpha", "alpha_4", "applied"} <= set(alphas)


def test_full_recipe_cli_resumes_without_training(corpus, plumbing, capsys,
                                                  tmp_path):
    """``full-recipe --device cpu`` on the built workspace: the same
    metrics, and no stage trains, generates data or calibrates again."""
    ws, kw, metrics = plumbing
    _, docs_dir, queries_dir, qrel_path = corpus
    cfg = tmp_path / "kw.json"
    cfg.write_text(json.dumps({**EPOCH1, **kw}))
    mtimes = {p: p.stat().st_mtime_ns for p in ws.rglob("params.pt")}
    capsys.readouterr()
    cli(["full-recipe", "--workspace", str(ws), "--docs", str(docs_dir),
         "--queries", str(queries_dir), "--qrel", str(qrel_path),
         "--config", str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    again = json.loads(out[out.index("{\n"):])
    assert list(again) == list(metrics)
    for tag, m in metrics.items():
        assert again[tag] == pytest.approx(m), tag
    assert ": training" not in out and "datagen at prefix" not in out
    assert "calibration" not in out and "encoding" not in out
    assert mtimes == {p: p.stat().st_mtime_ns for p in ws.rglob("params.pt")}


def test_full_recipe_refresh_gate_then_every_branch(corpus):
    """An unreachable min_teacher_mrr aborts the refreshed run with the
    gate's error; the same workspace then resumes through every phase-3
    branch at once. A teacher of one epoch may not separate at all, so
    the margin gate is opened: the MRR gate is the one under test."""
    ws = corpus[0] / "torch_ws_branches"
    teacher = dict(teacher_refresh=True, min_teacher_margin=float("-inf"))
    with pytest.raises(ValueError, match="candidate-ranking MRR@10"):
        _recipe(corpus, ws, min_teacher_mrr=1.01, **teacher)
    assert (ws / "checkpoints/bert_teacher_refresh/params.pt").exists()
    assert not (ws / "checkpoints/phase1_pretrain_1").exists()
    metrics = _recipe(corpus, ws, **teacher, calibrate_teacher_scale=True,
                      phase3_sym_neg=True, phase3_joint_seq2seq=True,
                      phase3_joint_weight=2.0,
                      phase3_seq2seq_rehearsal=True,
                      phase3_rehearsal_max_steps=2, phase3_pseudo_rank=1,
                      phase3_l2sp=0.1)
    assert set(metrics) == {"phase2", "phase3"}
    for name in ("bce_examples.bert_teacher_refresh.tsv",
                 "qid_to_reldocid_to_score.refresh.json",
                 "checkpoints/bert_teacher_refresh/bert_geometry.json",
                 "checkpoints/phase3_s2s_rhs_4/params.pt",
                 "checkpoints/phase3_s2s_rhs_8/params.pt"):
        assert (ws / name).exists(), name
    # sym-neg rows lead with the positive's smtid
    qrel = json.loads(Path(corpus[3]).read_text())
    d2s = {d: "_".join(map(str, c[1:])) for d, c in json.loads(
        (ws / "docid_to_smtid.json").read_text()).items()}
    examples = read_jsonl(str(ws / "lng_knp_qid_smtids_scores_8.train.json"))
    # phase3_pseudo_rank's queries get no rows: the sym-neg builder makes
    # rows for qrel queries only, as the JAX recipe's does (ROADMAP.md
    # Queue 3)
    assert examples and set(ex["qid"] for ex in examples) <= set(qrel)
    for ex in examples:
        assert ex["smtids"][0] in {d2s[d] for d in qrel[ex["qid"]]}
        assert all(len(s.split("_")) == 8 for s in ex["smtids"])


@pytest.mark.slow
def test_full_recipe_reaches_the_jax_floors(corpus):
    """The port's recipe at RECIPE_KW on the same corpus and seed must
    reach tests/test_full_recipe.py's floors (phase 2 and 3 recall@10 >=
    0.99, MRR@10 >= 0.70 and >= 0.30). Its initial draws come from
    torch generators (other values than flax's)."""
    tmp, docs_dir, queries_dir, qrel_path = corpus
    ws = tmp / "torch_ws_floors"
    metrics = fr.run_full_recipe(
        workspace=str(ws), docs_dir=str(docs_dir),
        queries_dir=str(queries_dir), qrel_path=str(qrel_path),
        device="cpu", **RECIPE_KW)
    assert set(metrics) == {"phase2", "phase3"}
    assert metrics["phase2"]["recall_10"] >= 0.99, metrics
    assert metrics["phase2"]["mrr_10"] >= 0.70, metrics
    assert metrics["phase3"]["recall_10"] >= 0.99, metrics
    assert metrics["phase3"]["mrr_10"] >= 0.30, metrics
    for name in ARTIFACTS:
        assert (ws / name).exists(), name
    for name in CHECKPOINTS:
        assert (ws / "checkpoints" / name / "params.pt").exists(), name
    scores = [s for ex in read_jsonl(
        str(ws / "lng_knp_qid_smtids_scores_8.train.json"))
        for s in ex["scores"]]
    assert np.isfinite(scores).all() and np.std(scores) > 0
