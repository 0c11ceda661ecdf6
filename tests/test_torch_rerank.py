"""The port's reranking against the JAX package, on the CPU: the engines
(ripor_tpu_torch.evaluation.reranker), all eight rerank task/merge pairs
(rerank_tasks), load_bert_teacher on a JAX-saved Orbax teacher and on the
port's params.pt, run_train_from_config for the four teacher and baseline
loss types, and the CLI commands rerank, rerank-task and
rerank-task-merge against the JAX CLI on a JAX-written workspace.

Fed one deterministic numpy score function, the engines return what the
JAX ones return and every task writes files byte-equal to the JAX
package's. Where the model scores: float32 scores rtol 1e-5 / atol 1e-5
(tests/test_torch_teacher.py's forward bars, through a sum); the bfloat16
self-rerank of the CLI within 3e-2 * max(1, the largest |score| of the
run) — a score sums dot products that partly cancel, so its own size is
no measure of its bf16 error; trained params as
tests/test_torch_teacher.py holds optimizer steps.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.cli.main import main as jax_cli
from ripor_tpu.data import Collection as JaxCollection
from ripor_tpu.data import HashTokenizer as JaxHashTokenizer
from ripor_tpu.data import UnigramTokenizer as JaxUnigramTokenizer
from ripor_tpu.data import datasets as jax_ds
from ripor_tpu.evaluation import rerank_tasks as jax_rt
from ripor_tpu.evaluation import reranker as jax_rr
from ripor_tpu.models import RiporConfig as JaxRiporConfig
from ripor_tpu.models import T5Config as JaxT5Config
from ripor_tpu.models.cross_encoder import \
    BertCrossEncoder as JaxBertCrossEncoder
from ripor_tpu.models.cross_encoder import \
    T5SeqCrossEncoder as JaxT5SeqCrossEncoder
from ripor_tpu.models.dense_encoder import T5DenseEncoder as JaxT5DenseEncoder
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.pipeline.e2e import \
    run_train_from_config as jax_run_train_from_config
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data.datasets import Collection
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.evaluation import rerank_tasks as rt
from ripor_tpu_torch.evaluation import reranker as rr
from ripor_tpu_torch.models import (BertCrossEncoder, RiporConfig,
                                    T5DenseEncoder, T5SeqCrossEncoder)
from ripor_tpu_torch.pipeline import load_tokenizer
from ripor_tpu_torch.pipeline.e2e import run_train_from_config
from ripor_tpu_torch.train import load_params, save_params
from torch_parity import port_state_dict
from torch_parity import setup as parity_setup

N_DOCS, N_Q = 16, 6
BERT_GEO = dict(d_model=32, num_layers=2, num_heads=4, d_ff=64,
                max_position=64, dropout=0.0)


def det_score(ids, mask):
    """Deterministic stand-in teacher: distinct per (q, d) pair."""
    return ((ids * mask).sum(axis=1) % 997).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Texts, both packages' collections and tokenizers, and the rerank
    tasks' inputs."""
    tmp = tmp_path_factory.mktemp("rerank")
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    docs = [" ".join(rng.choice(words, rng.integers(3, 40)))
            for _ in range(N_DOCS)]
    queries = [" ".join(rng.choice(words, rng.integers(1, 6)))
               for _ in range(N_Q)]
    for name, texts, pre in (("docs", docs, "d"), ("queries", queries, "q")):
        (tmp / name).mkdir()
        (tmp / name / "raw.tsv").write_text(
            "".join(f"{pre}{i}\t{t}\n" for i, t in enumerate(texts)))
    d2s = {f"d{i}": rng.integers(0, 3, 4).tolist() for i in range(N_DOCS)}
    d2s["d1"] = list(d2s["d0"])     # a collision pool
    qids = [f"q{i}" for i in range(N_Q)]
    docids = [f"d{i}" for i in range(N_DOCS)]
    run = {q: {d: float(s) for d, s in zip(
        rng.choice(docids, 5, replace=False), rng.standard_normal(5))}
        for q in qids}
    smtid = jax_ds.smtid_to_str
    inputs = {
        "run": run,
        "docid_pseudo_qids": {d: list(rng.choice(qids, 2, replace=False))
                              for d in docids[:7]},
        "qid_docids": {q: list(run[q]) for q in qids},
        "qid_smtid_rank": {q: {smtid(d2s[d]): 1.0 for d in list(run[q])[:3]}
                           for q in qids},
        "qrel": {q: {docids[i]: 1} for i, q in enumerate(qids)},
        "pools": {q: {docids[i]: list(rng.choice(docids, 3, replace=False))}
                  for i, q in enumerate(qids[:4])},
        "qid_smtid_docids": {q: {smtid(d2s["d0"]): ["d0", "d1", docids[i]]}
                             for i, q in enumerate(qids)},
    }
    return dict(tmp=tmp, d2s=d2s, inputs=inputs, docs=docs,
                queries=queries,
                port=(Collection(tmp / "queries"), Collection(tmp / "docs"),
                      HashTokenizer(512)),
                jax=(JaxCollection(tmp / "queries"),
                     JaxCollection(tmp / "docs"), JaxHashTokenizer(512)))


def test_encode_pairs_equal_jax(world):
    qs = world["queries"] + ["", "a " * 200]
    ds = world["docs"][:len(qs) - 1] + ["b " * 300]
    for max_length in (16, 48):
        got = rr.encode_pairs(world["port"][2], qs, ds, max_length)
        want = jax_rr.encode_pairs(world["jax"][2], qs, ds, max_length)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_pair_engines_equal_jax(world):
    pairs = [(q, d) for q, dd in world["inputs"]["run"].items() for d in dd]
    qsd = world["inputs"]["qid_smtid_docids"]
    out = {}
    for pkg, mod in (("port", rr), ("jax", jax_rr)):
        queries, docs, tok = world[pkg]
        out[pkg] = (
            mod.rerank_pairs(det_score, tok, queries, docs, pairs, 7, 40),
            mod.rerank_qid_smtid_docids(det_score, tok, queries, docs, qsd,
                                        5, 40),
            mod.add_qrel_positives(world["inputs"]["run"],
                                   world["inputs"]["qrel"], boost=2.0))
    for g, w in zip(out["port"], out["jax"]):
        assert json.dumps(g) == json.dumps(w)


@pytest.fixture(scope="module")
def ripor(world):
    """A toy RiporModel: the JAX config and params, the port's config
    and state_dict."""
    cfg, params, *_ = parity_setup(M=4, K=8)
    pcfg = RiporConfig.from_json(cfg.to_json())
    return cfg, params, pcfg, port_state_dict(params, pcfg)


def _model_scores(world, ripor, name, mod, pkg, dtype):
    cfg, params, pcfg, sd = ripor
    queries, docs, tok = world[pkg]
    kw = dict(batch_size=4, max_length=16, dtype=dtype)
    if pkg == "port":
        cfg, params = pcfg, sd
        kw["device"] = "cpu"
    d2s = {d: c[:4] for d, c in world["d2s"].items()}
    pairs = [(q, d) for q, dd in world["inputs"]["run"].items() for d in dd]
    if name == "self_rerank_pair_scores":
        return mod.self_rerank_pair_scores(cfg, params, tok, queries, d2s,
                                           pairs, **kw)
    if name == "rerank_query_smtids":
        q2s = {q: sorted({jax_ds.smtid_to_str(d2s[d][:n])
                          for d, n in zip(dd, (1, 2, 4, 3, 4))})
               for q, dd in world["inputs"]["run"].items()}
        return mod.rerank_query_smtids(cfg, params, tok, queries, q2s, **kw)
    triples = [(q, d, d2s[d][:2]) for q, d in pairs]
    return mod.rerank_cond_prefix(cfg, params, tok, queries, docs, triples,
                                  **kw)


@pytest.mark.parametrize("name", ["self_rerank_pair_scores",
                                  "rerank_query_smtids",
                                  "rerank_cond_prefix"])
def test_model_engines_match_jax(world, ripor, name):
    got = _model_scores(world, ripor, name, rr, "port", torch.float32)
    want = _model_scores(world, ripor, name, jax_rr, "jax", jnp.float32)
    assert list(got) == list(want)
    for q in want:
        assert list(got[q]) == list(want[q])
        np.testing.assert_allclose(list(got[q].values()),
                                   list(want[q].values()), rtol=1e-5,
                                   atol=1e-5)


# ---- the eight task/merge pairs ----

TASKS = ("rerank_for_create_trainset", "rerank_for_evaluate",
         "assign_scores_for_pseudo_queries",
         "query_to_docid_rerank_for_qid_smtids",
         "teacher_rerank_for_qid_smtids",
         "cross_encoder_rerank_for_same_prefix_docid",
         "cross_encoder_rerank_for_same_reldocid_hard_docids",
         "cross_encoder_rerank_for_qid_smtid_docids")


def fake_query_smtids(cfg, params, tok, queries, qid_to_smtids,
                      batch_size=64, max_length=64, **kw):
    """A deterministic stand-in for the model's (query, smtid) scores."""
    return {q: {s: float(sum(map(int, s.split("_"))) * 10 + len(queries[q])
                         + i) for i, s in enumerate(smtids)}
            for q, smtids in qid_to_smtids.items()}


def _task_pass(mod, world, pkg, task, out, rank, nranks):
    queries, docs, tok = world[pkg]
    inp = world["inputs"]
    kw = dict(rank=rank, nranks=nranks, batch_size=5, max_length=40)
    d2s = world["d2s"]
    if task in ("rerank_for_create_trainset", "rerank_for_evaluate"):
        mod.rerank_for_create_trainset(det_score, tok, queries, docs,
                                       inp["run"], out, **kw)
    elif task == "assign_scores_for_pseudo_queries":
        mod.assign_scores_for_pseudo_queries(
            det_score, tok, queries, docs, inp["docid_pseudo_qids"], out,
            **kw)
    elif task == "query_to_docid_rerank_for_qid_smtids":
        mod.query_to_docid_rerank_for_qid_smtids(
            None, None, tok, queries, inp["qid_docids"], d2s, out, **kw)
    elif task == "teacher_rerank_for_qid_smtids":
        mod.teacher_rerank_for_qid_smtids(det_score, tok, queries, docs,
                                          inp["qid_smtid_rank"], d2s, out,
                                          **kw)
    elif task == "cross_encoder_rerank_for_same_prefix_docid":
        mod.cross_encoder_rerank_for_same_prefix_docid(
            det_score, tok, queries, docs, d2s, inp["qrel"], out,
            neg_sample=3, seed=1, **kw)
    elif task == "cross_encoder_rerank_for_same_reldocid_hard_docids":
        mod.cross_encoder_rerank_for_same_reldocid_hard_docids(
            det_score, tok, queries, docs, inp["pools"], out, **kw)
    else:
        src = f"{out}/qid_smtid_docids.train.json"
        with open(src, "w") as f:
            json.dump(inp["qid_smtid_docids"], f)
        mod.cross_encoder_rerank_for_qid_smtid_docids(
            det_score, tok, queries, docs, src, **kw)


def _task_merge(mod, world, task, out, nranks):
    if task == "rerank_for_create_trainset":
        mod.rerank_for_create_trainset_merge(out, topk=3, nranks=nranks)
    elif task == "rerank_for_evaluate":
        mod.rerank_for_evaluate_merge(out, nranks=nranks)
    elif task == "query_to_docid_rerank_for_qid_smtids":
        mod.query_to_docid_rerank_for_qid_smtids_merge(
            out, world["d2s"], world["inputs"]["qrel"], nranks=nranks)
    elif task == "cross_encoder_rerank_for_same_prefix_docid":
        mod.cross_encoder_rerank_for_same_prefix_docid_merge(out,
                                                             nranks=nranks)
    else:
        getattr(mod, task + "_merge")(out, nranks=nranks)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("task", TASKS)
def test_task_and_merge_write_the_jax_bytes(world, tmp_path, monkeypatch,
                                            task):
    """Two ranks, then the merge (which checks both shards exist): the
    shards and the merged artifact byte-equal to the JAX package's; the
    merged artifact also equal to a one-rank run's."""
    for mod in (rt, jax_rt):
        monkeypatch.setattr(mod, "rerank_query_smtids", fake_query_smtids)
    merged = {}
    for pkg, mod in (("port", rt), ("jax", jax_rt)):
        out = tmp_path / pkg
        out.mkdir()
        for rank in range(2):
            _task_pass(mod, world, pkg, task, str(out), rank, 2)
        shards = _files(out)
        assert len(shards) >= 2
        if pkg == "port":
            with pytest.raises(FileNotFoundError, match="ranks"):
                _task_merge(mod, world, task, str(out), 3)
        _task_merge(mod, world, task, str(out), 2)
        merged[pkg] = (shards, _files(out))
    assert merged["port"] == merged["jax"]
    if task == "cross_encoder_rerank_for_same_prefix_docid":
        return          # the negatives are drawn per rank (seed + rank)
    one = tmp_path / "one"
    one.mkdir()
    _task_pass(rt, world, "port", task, str(one), 0, 1)
    _task_merge(rt, world, task, str(one), 1)
    shards, final = merged["port"]
    for name in set(final) - set(shards):
        got, want = (one / name).read_text(), final[name].decode()
        if name == "qid_docids_teacher_scores.train.json":      # JSONL
            assert sorted(got.splitlines()) == sorted(want.splitlines())
        else:
            assert json.loads(got) == json.loads(want), name


# ---- teachers: load_bert_teacher and run_train_from_config ----

@pytest.fixture(scope="module")
def teacher(world, tmp_path_factory):
    """A BertCrossEncoder teacher saved by the JAX package (Orbax, with
    bert_geometry.json) and the same params as the port's params.pt."""
    tmp = tmp_path_factory.mktemp("teacher")
    jm = JaxBertCrossEncoder(vocab_size=512, **BERT_GEO)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jm.init({"params": jax.random.PRNGKey(7)}, ids, ids)["params"]
    jax_dir, port_dir = tmp / "jax_teacher", tmp / "port_teacher"
    jax_save_params(jax_dir, params)
    geo = json.dumps(BERT_GEO)
    (jax_dir / "bert_geometry.json").write_text(geo)
    pytest.importorskip("tensorstore")
    save_params(port_dir, load_params(jax_dir, model=BertCrossEncoder(
        vocab_size=512, device="meta", **BERT_GEO)))
    (port_dir / "bert_geometry.json").write_text(geo)
    return jax_dir, port_dir


def test_load_bert_teacher_scores_as_jax(world, teacher):
    jax_dir, port_dir = teacher
    queries, docs = world["queries"], world["docs"][:N_Q]
    ids, mask = rr.encode_pairs(world["port"][2], queries, docs, 48)
    ids = np.concatenate([ids, np.full((1, 48), 7, np.int32)])  # no [SEP]
    mask = np.concatenate([mask, np.ones((1, 48), np.int32)])
    want = jax_rr.load_bert_teacher(str(jax_dir), 512)(ids, mask)
    for d in (jax_dir, port_dir):
        got = rr.load_bert_teacher(str(d), 512, device="cpu")(ids, mask)
        assert got.dtype == np.float32 and got.shape == (N_Q + 1,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def unigram(world):
    """A Unigram tokenizer the JAX package trained on the texts: (its
    file, its vocabulary size)."""
    path = world["tmp"] / "tokenizer.json"
    JaxUnigramTokenizer.train(world["docs"] + world["queries"],
                              vocab_size=100).save(path)
    return path, JaxUnigramTokenizer.load(path).vocab_size


@pytest.fixture(scope="module")
def train_ws(world, unigram, tmp_path_factory):
    """A JAX-written training workspace: the Unigram tokenizer, codes, a
    bce_examples TSV, a teacher-score trainset and, for each family, init
    params saved by the JAX package."""
    tmp = tmp_path_factory.mktemp("train")
    ws = tmp / "ws"
    ws.mkdir()
    (ws / "tokenizer.json").write_bytes(unigram[0].read_bytes())
    tok_v = unigram[1]
    docids = list(world["d2s"])
    jax_ds.save_docid_to_smtid(ws / "docid_to_smtid.json", docids,
                               np.asarray([world["d2s"][d] for d in docids]))
    rng = np.random.default_rng(1)
    jax_ds.save_bce_examples(tmp / "bce.tsv", jax_ds.build_bce_examples(
        world["inputs"]["qrel"], world["inputs"]["run"], neg_sample=1))
    with open(tmp / "train.jsonl", "w") as f:
        for q in world["inputs"]["run"]:
            f.write(json.dumps({
                "qid": q, "docids": list(world["inputs"]["run"][q])[:3],
                "scores": sorted(rng.standard_normal(3).tolist())[::-1]})
                + "\n")
    cfg = JaxRiporConfig(t5=JaxT5Config(
        vocab_size=tok_v, d_model=32, d_kv=8, d_ff=64, num_layers=2,
        num_decoder_layers=2, num_heads=4, dropout_rate=0.0), M=4, K=3)
    cfg.save(tmp / "model_config.json")
    ids = jnp.ones((1, 8), jnp.int32)
    key = jax.random.PRNGKey(3)
    inits = {
        "bert_bce": JaxBertCrossEncoder(vocab_size=tok_v, **BERT_GEO).init(
            {"params": key}, ids, ids),
        "t5seq_bce": JaxT5SeqCrossEncoder(cfg).init(
            {"params": key}, ids, ids, jnp.zeros((1, 4), jnp.int32)),
        "dense": JaxT5DenseEncoder(cfg.t5).init({"params": key}, ids, ids)}
    for name, p in inits.items():
        jax_save_params(tmp / f"init_{name}", p["params"])
    return dict(tmp=tmp, ws=ws, cfg=cfg, tok_v=tok_v)


def _train_config(world, train_ws, loss_type, phase):
    tmp = train_ws["tmp"]
    bce = loss_type.endswith("bce")
    init = loss_type if bce else "dense"
    return {"workspace": str(train_ws["ws"]),
            "queries_dir": str(world["tmp"] / "queries"),
            "docs_dir": str(world["tmp"] / "docs"),
            "examples_path": str(tmp / ("bce.tsv" if bce else
                                        "train.jsonl")),
            "loss_type": loss_type, "bert_geometry": BERT_GEO,
            "model_config": str(tmp / "model_config.json"),
            "init_checkpoint": str(tmp / f"init_{init}"), "batch_size": 4,
            "max_length": 24, "learning_rate": 1e-3, "total_steps": 10,
            "phase_name": phase}


@pytest.mark.parametrize("loss_type", ["bert_bce", "t5seq_bce",
                                       "margin_mse", "kldiv"])
def test_run_train_from_config_matches_jax(world, train_ws, loss_type):
    pytest.importorskip("tensorstore")
    cfg = _train_config(world, train_ws, loss_type, f"jax_{loss_type}")
    jax_run_train_from_config(cfg)
    got = run_train_from_config(dict(cfg, phase_name=f"port_{loss_type}"),
                                device="cpu")
    pcfg = RiporConfig.load(cfg["model_config"])
    model = {"bert_bce": lambda: BertCrossEncoder(
        vocab_size=train_ws["tok_v"], device="meta", **BERT_GEO),
        "t5seq_bce": lambda: T5SeqCrossEncoder(pcfg, device="meta")}.get(
        loss_type, lambda: T5DenseEncoder(pcfg.t5, device="meta"))()
    ckpt = train_ws["ws"] / "checkpoints"
    want = load_params(ckpt / f"jax_{loss_type}", model=model)
    init = load_params(cfg["init_checkpoint"], model=model)
    assert set(got) == set(want) == set(model.state_dict())
    assert (ckpt / f"port_{loss_type}" / "config.json").exists() == (
        loss_type != "bert_bce")
    steps, moved = 2, 0
    for n in want:
        g, w = got[n].numpy(), want[n].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * steps * 1e-3,
                                   err_msg=n)
        moved += int(not torch.equal(got[n], init[n]))
        if n.endswith("attn.k.bias"):
            continue        # a gradient of rounding noise
        loose = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert loose.mean() <= 1e-3, (n, int(loose.sum()), w.size)
    assert moved == len(want)


# ---- the CLI against the JAX CLI ----

@pytest.fixture(scope="module")
def cli_ws(world, unigram, ripor, tmp_path_factory):
    """A JAX-written workspace: the RIPOR model's Orbax checkpoint, codes,
    a run, and a BertCrossEncoder teacher at the tokenizer's vocabulary
    (Orbax, with bert_geometry.json)."""
    tmp = tmp_path_factory.mktemp("cli")
    ws = tmp / "ws"
    cfg = ripor[0]
    jax_save_params(ws / "checkpoints" / "final",
                    init_ripor_params(jax.random.PRNGKey(5), cfg), cfg)
    d2s = {d: c[:cfg.M] for d, c in world["d2s"].items()}
    jax_ds.save_docid_to_smtid(tmp / "d2s.json", list(d2s),
                               np.asarray(list(d2s.values())))
    (tmp / "run.json").write_text(json.dumps(world["inputs"]["run"]))
    (tmp / "qid_docids.json").write_text(json.dumps(
        world["inputs"]["qid_docids"]))
    ids = jnp.ones((1, 8), jnp.int32)
    jax_save_params(tmp / "teacher", JaxBertCrossEncoder(
        vocab_size=unigram[1], **BERT_GEO).init(
        {"params": jax.random.PRNGKey(6)}, ids, ids)["params"])
    (tmp / "teacher" / "bert_geometry.json").write_text(json.dumps(BERT_GEO))
    return dict(tmp=tmp, ws=ws, teacher=tmp / "teacher",
                tokenizer=unigram[0], vocab=unigram[1])


def _rerank_args(cli_ws, world, out):
    tmp = cli_ws["tmp"]
    return ["rerank", "--run", str(tmp / "run.json"),
            "--queries", str(world["tmp"] / "queries"),
            "--docs", str(world["tmp"] / "docs"),
            "--tokenizer", str(cli_ws["tokenizer"]),
            "--ce-checkpoint", str(cli_ws["teacher"]),
            "--ce-vocab-size", str(cli_ws["vocab"]), "--topk", "4",
            "--batch-size", "8",
            "--max-length", "48", "--out", str(out)]


def _close_jsonl(got, want, sort=False):
    g, w = ([json.loads(ln) for ln in open(p)] for p in (got, want))
    if sort:
        g, w = (sorted(rows, key=lambda r: r["qid"]) for rows in (g, w))
    assert [r["qid"] for r in g] == [r["qid"] for r in w]
    for a, b in zip(g, w):
        assert a["docids"] == b["docids"]
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5,
                                   atol=1e-5)


def test_cli_rerank_matches_the_jax_cli(world, cli_ws, capsys):
    pytest.importorskip("tensorstore")
    tmp = cli_ws["tmp"]
    jax_cli(_rerank_args(cli_ws, world, tmp / "jax.jsonl"))
    cli(_rerank_args(cli_ws, world, tmp / "port.jsonl") + ["--device", "cpu"])
    _close_jsonl(tmp / "port.jsonl", tmp / "jax.jsonl")
    assert "wrote" in capsys.readouterr().out


def _task_args(cli_ws, world, task, out, rank, nranks):
    tmp = cli_ws["tmp"]
    return ["rerank-task", "--task", task, "--out-dir", str(out),
            "--tokenizer", str(cli_ws["tokenizer"]),
            "--queries", str(world["tmp"] / "queries"),
            "--docs", str(world["tmp"] / "docs"),
            "--ce-checkpoint", str(cli_ws["teacher"]),
            "--run", str(tmp / "run.json"),
            "--input-json", str(tmp / "qid_docids.json"),
            "--docid-to-smtid", str(tmp / "d2s.json"),
            "--workspace", str(cli_ws["ws"]), "--rank", str(rank),
            "--nranks", str(nranks), "--batch-size", "8",
            "--max-length", "24"]


@pytest.mark.parametrize("task", ["rerank_for_create_trainset",
                                  "query_to_docid_rerank_for_qid_smtids"])
def test_cli_rerank_task_and_merge_match_the_jax_cli(world, cli_ws, task):
    """Two ranks and the merge through each CLI; the merged artifact of
    the port equal to the JAX CLI's (scores within the bars above: the
    teacher in float32, the RIPOR self-rerank in bfloat16) and to a
    one-rank run of the port's CLI (the same queries and candidates,
    scores within 1e-5: other batches, other float sums)."""
    pytest.importorskip("tensorstore")
    tmp = cli_ws["tmp"]
    outs = {}
    for tag, main, nranks, extra in (
            ("jax", jax_cli, 2, []), ("port", cli, 2, ["--device", "cpu"]),
            ("port1", cli, 1, ["--device", "cpu"])):
        out = tmp / f"{task}_{tag}"
        for rank in range(nranks):
            main(_task_args(cli_ws, world, task, out, rank, nranks) + extra)
        merge = ["rerank-task-merge", "--task", task, "--out-dir", str(out),
                 "--nranks", str(nranks), "--topk", "3",
                 "--docid-to-smtid", str(tmp / "d2s.json")]
        main(merge)
        outs[tag] = out
    if task == "rerank_for_create_trainset":
        name = "qid_docids_teacher_scores.train.json"
        _close_jsonl(outs["port"] / name, outs["jax"] / name)
        # the one-rank merge lists the queries in another order
        _close_jsonl(outs["port"] / name, outs["port1"] / name, sort=True)
        return
    name = "qid_smtids_rerank.json"
    g, w, one = (json.loads((outs[t] / name).read_text())
                 for t in ("port", "jax", "port1"))
    assert list(g) == list(w) and sorted(g) == sorted(one)
    top = max(abs(v) for q in w for v in w[q].values())
    for q in w:
        assert set(g[q]) == set(w[q]) == set(one[q])
        for s, v in w[q].items():
            assert abs(g[q][s] - v) <= 3e-2 * max(1.0, top), (q, s)
            assert abs(g[q][s] - one[q][s]) <= 1e-5 * max(1.0, top)


# ---- reference faults the port keeps (ROADMAP.md Queue 3) ----

def test_bert_bce_checkpoint_lacks_its_geometry(world, train_ws):
    """run_train_from_config with a bert_geometry writes no
    bert_geometry.json (as the JAX package), so load_bert_teacher on the
    checkpoint rebuilds the default geometry and cannot load it; passing
    the geometry loads it."""
    cfg = _train_config(world, train_ws, "bert_bce", "port_geometry")
    run_train_from_config(cfg, device="cpu")
    ckpt = train_ws["ws"] / "checkpoints" / "port_geometry"
    assert (ckpt / "params.pt").exists()
    assert not (ckpt / "bert_geometry.json").exists()
    with pytest.raises(RuntimeError, match="size mismatch"):
        rr.load_bert_teacher(str(ckpt), train_ws["tok_v"], device="cpu")
    tok = load_tokenizer(train_ws["ws"] / "tokenizer.json")
    ids, mask = rr.encode_pairs(tok, world["queries"], world["docs"][:N_Q],
                                24)
    scores = rr.load_bert_teacher(str(ckpt), train_ws["tok_v"],
                                  geometry=BERT_GEO, device="cpu")(ids, mask)
    assert scores.shape == (N_Q,) and np.isfinite(scores).all()


def test_rerank_vocab_default_is_not_the_tokenizers(world, cli_ws):
    """``rerank --ce-vocab-size`` defaults to 32000 (the JAX CLI's
    default) while a teacher trains at the tokenizer's vocabulary: without
    the flag the teacher does not load, in either CLI."""
    pytest.importorskip("tensorstore")
    args = _rerank_args(cli_ws, world, cli_ws["tmp"] / "default.jsonl")
    i = args.index("--ce-vocab-size")
    args = args[:i] + args[i + 2:]
    assert cli_ws["vocab"] != 32000
    with pytest.raises(ValueError, match="does not fit"):
        cli(args + ["--device", "cpu"])
    with pytest.raises(Exception):
        jax_cli(args)


def test_load_bert_teacher_ignores_batch_compile(world, teacher):
    """``batch_compile`` is accepted and read by neither package."""
    ids, mask = rr.encode_pairs(world["port"][2], world["queries"],
                                world["docs"][:N_Q], 32)
    a, b = (rr.load_bert_teacher(str(teacher[1]), 512, batch_compile=flag,
                                 device="cpu")(ids, mask)
            for flag in (True, False))
    np.testing.assert_array_equal(a, b)
