"""The port's entry points (ripor_tpu_torch.cli.main, pipeline.recipe,
serve.http) on a toy workspace that the JAX package wrote: Orbax params,
a WordTokenizer, docid_to_smtid.json (the tests/test_sharded_retrieve.py
geometry at M=8, so the port's CLI takes its megarow path). The word
tokenizer keeps the inputs the same from run to run (the Unigram trainer
is not deterministic); tests/test_torch_host.py reads a Unigram file.

The port's CLI runs with --device cpu. Against the JAX CLI both decode in
bfloat16, which rounds at other places in the two frameworks, so the bar
is tests/test_torch_engine.py's: same qids, top-1 docid equal, scores
within rtol 2e-2 of the query's score scale. Against the port's own
RetrievalEngine, sharded runs and evaluate the results must be equal."""
import http.client
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.cli.main import main as jax_cli
from ripor_tpu.data import WordTokenizer as JaxWordTokenizer
from ripor_tpu.data import save_docid_to_smtid as jax_save_docid_to_smtid
from ripor_tpu.decode import expand_groups_to_docids as jax_expand_groups
from ripor_tpu.decode.beam import make_beam_search_fn as jax_beam_fn
from ripor_tpu.evaluation import evaluate_run as jax_evaluate_run
from ripor_tpu.evaluation import load_and_evaluate as jax_load_and_evaluate
from ripor_tpu.models import RiporConfig as JaxRiporConfig
from ripor_tpu.models import T5Config as JaxT5Config
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.pipeline.recipe import Workspace as JaxWorkspace
from ripor_tpu.pipeline.recipe import load_tokenizer as jax_load_tokenizer
from ripor_tpu.pipeline.recipe import stage_retrieve as jax_stage_retrieve
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu.trie import build_trie as jax_build_trie
from ripor_tpu.trie import succinct_tables as jax_succinct_tables
from ripor_tpu_torch.cli.main import _bf16_model
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data.datasets import Collection, load_docid_to_smtid
from ripor_tpu_torch.data.tokenizer import tokenize_queries
from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
from ripor_tpu_torch.models import RiporConfig, RiporModel
from ripor_tpu_torch.pipeline import (Workspace, load_tokenizer,
                                      stage_evaluate, stage_retrieve)
from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig, serve_http
from ripor_tpu_torch.serve import http as port_http
from ripor_tpu_torch.train import load_params
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch

M, K, N_DOCS, N_QUERIES = 8, 16, 30, 11
BEAM, TOPK = 4, 10


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A workspace written by the JAX package, the JAX CLI's run of it
    (run_jax.json) and the port CLI's (run.json)."""
    tmp = tmp_path_factory.mktemp("torch_cli_ws")
    jws = JaxWorkspace(tmp / "ws")
    cfg = JaxRiporConfig(
        t5=JaxT5Config(vocab_size=300, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_decoder_layers=2, num_heads=4,
                       dropout_rate=0.0),
        M=M, K=K)
    params = init_ripor_params(jax.random.PRNGKey(0), cfg)
    jax_save_params(jws.path("checkpoints/final"), params, cfg)
    corpus = [f"document number {i} about subject {i % 7}"
              for i in range(N_DOCS)]
    tok = JaxWordTokenizer.train(corpus, vocab_size=300)
    tok.save(jws.path("tokenizer.json"))
    codes = np.random.default_rng(0).integers(0, K, (N_DOCS, M))
    jax_save_docid_to_smtid(jws.path("docid_to_smtid.json"),
                            [f"d{i}" for i in range(N_DOCS)], codes)
    qdir = tmp / "queries"
    qdir.mkdir()
    with open(qdir / "raw.tsv", "w") as f:
        for i in range(N_QUERIES):
            f.write(f"q{i}\tsubject {i} document {i % 3}\n")
    base = ["--workspace", str(jws.root), "--queries", str(qdir),
            "--beam", str(BEAM), "--topk", str(TOPK)]
    jax_cli(["retrieve", *base, "--run-name", "run_jax.json"])
    cli(["retrieve", *base, "--device", "cpu"])
    return dict(root=jws.root, qdir=qdir, base=base, jax_params=params,
                jax_cfg=cfg, codes=codes)


def _run(ws, name="run.json"):
    return json.loads((Path(ws["root"]) / name).read_text())


def _assert_close(got, want):
    """Per query: top-1 docid equal, scores within rtol 2e-2 of the
    query's score scale (the largest |score|)."""
    assert list(got) == list(want)
    for qid in want:
        g, w = list(got[qid].items()), list(want[qid].items())
        assert g and w and g[0][0] == w[0][0], qid
        n = min(len(g), len(w))
        scale = max(abs(s) for _, s in w)
        np.testing.assert_allclose([s for _, s in g[:n]],
                                   [s for _, s in w[:n]], rtol=2e-2,
                                   atol=2e-2 * scale)
        assert [s for _, s in g] == sorted((s for _, s in g), reverse=True)


def test_cli_retrieve_matches_jax_cli(ws):
    run = _run(ws)
    assert set(run) == {f"q{i}" for i in range(N_QUERIES)}
    # one doc a group (distinct codes), so BEAM < TOPK docs a query
    assert all(len(docs) == BEAM for docs in run.values())
    _assert_close(run, _run(ws, "run_jax.json"))


def _port_world(ws):
    root = Path(ws["root"])
    cfg = RiporConfig.load(root / "checkpoints/final/config.json")
    docids, codes = load_docid_to_smtid(root / "docid_to_smtid.json")
    return (cfg, load_params(root / "checkpoints/final"),
            load_tokenizer(root / "tokenizer.json"), build_trie(codes, K),
            docids)


def test_cli_retrieve_equals_engine(ws):
    """The CLI's run equals the port's RetrievalEngine on the same
    queries at the CLI's batch of 8: same docids in the same order, same
    scores."""
    cfg, params, tok, trie, docids = _port_world(ws)
    eng = RetrievalEngine(cfg, params, tok, trie, docids,
                          ServeConfig(num_beams=BEAM, topk=TOPK,
                                      batch_sizes=(8,)), device="cpu")
    queries = Collection(ws["qdir"])
    want = eng.retrieve_batch(queries.texts)
    run = _run(ws)
    assert list(run) == queries.ids
    for qid, res in zip(queries.ids, want):
        assert list(run[qid].items()) == res


def test_sharded_retrieve_merge_equals_single(ws):
    root = Path(ws["root"])
    for rank in (0, 1):
        cli(["retrieve", *ws["base"], "--device", "cpu", "--rank", str(rank),
             "--nranks", "2", "--run-name", "run_shard.json"])
    assert (root / "run_shard_0.json").exists()
    cli(["retrieve-merge", "--workspace", str(root), "--nranks", "2",
         "--run-name", "run_shard.json"])
    assert not (root / "run_shard_1.json").exists()
    single, merged = _run(ws), _run(ws, "run_shard.json")
    assert set(merged) == set(single)
    for qid in single:
        assert list(merged[qid].items()) == list(single[qid].items())
    with pytest.raises(SystemExit):
        cli(["retrieve-merge", "--workspace", str(root), "--nranks", "3"])


def test_evaluate_prints_jax_numbers(ws, tmp_path, capsys):
    """evaluate and stage_evaluate against the JAX package on the port's
    run and a qrel marking docs at several ranks."""
    run = _run(ws)
    rng = np.random.default_rng(1)
    qrel = {}
    for i, (qid, docs) in enumerate(run.items()):
        if i % 4 == 3:
            continue                       # a query without judgments
        ranked = list(docs)
        picks = rng.choice(len(ranked), size=1 + i % 3, replace=False)
        qrel[qid] = {ranked[p]: int(1 + p % 2) for p in picks}
        qrel[qid]["d_unretrieved"] = 1
    qrel_path = tmp_path / "qrel.json"
    qrel_path.write_text(json.dumps(qrel))
    run_path = Path(ws["root"]) / "run.json"
    metrics = ["mrr_10", "recall_5", "ndcg_cut_10"]
    capsys.readouterr()
    cli(["evaluate", "--qrel", str(qrel_path), "--run", str(run_path),
         "--metric", *metrics])
    got = json.loads(capsys.readouterr().out)
    want = {}
    for m in metrics:
        want.update(jax_load_and_evaluate(str(qrel_path), str(run_path), m))
    assert got == want
    perf = stage_evaluate(Workspace(tmp_path), run, qrel, metrics)
    assert perf == {m: jax_evaluate_run(run, qrel, m) for m in metrics}
    assert json.loads((tmp_path / "perf.json").read_text()) == perf


@pytest.mark.parametrize("max_steps", [4, 6])
def test_max_steps_prefix_run_matches_jax(ws, tmp_path, max_steps):
    """The sub-smtid run: a trie of codes truncated to max_steps.

    In f32, the port's stage_retrieve equals the JAX package's stage body
    (its beam search, then expand_groups_to_docids): codes equal on live
    beams, the same docs in the same order, scores within rtol 1e-5 of the
    query's score scale (a beam score sums logits of |x| ~ 8 here, and f32
    rounding scales with them, not with a sum that may cancel toward 0).
    In bf16 (JAX stage_retrieve's dtype), each doc both runs retrieve has
    scores within rtol 2e-2 of the run's score scale. Top-1 is not held in
    bf16: at max_steps 6, q1's top two beams are 0.247 apart in f32 and
    each framework's bf16 run moves a score by up to 0.30, so the two bf16
    runs order them differently (and each differs from f32 as much)."""
    cfg, params, tok, _, docids = _port_world(ws)
    prefix = ws["codes"][:, :max_steps]
    trie, jtrie = build_trie(prefix, K), jax_build_trie(prefix, K)
    queries = Collection(ws["qdir"])
    ids, mask = tokenize_queries(tok, queries.texts, 64)

    jfn = jax_beam_fn(ws["jax_cfg"], BEAM, max_steps=max_steps,
                      dtype=jnp.float32, use_pallas_gather=False)
    s0, c0, st0 = (np.asarray(a) for a in jfn(
        ws["jax_params"], jnp.asarray(ids), jnp.asarray(mask),
        jax.tree.map(jnp.asarray, jax_succinct_tables(jtrie))))
    groups = np.where(st0 <= -2, -2 - st0, -1)
    want = {}
    for q, qid in enumerate(queries.ids):
        docs, ss = jax_expand_groups(jtrie, groups[q], s0[q], TOPK)
        want[qid] = [(docids[d], float(v)) for d, v in zip(docs, ss)]

    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(params)
    fn = make_beam_search_fn(cfg, BEAM, max_steps=max_steps,
                             dtype=torch.float32, device="cpu")
    s1, c1, _ = (a.numpy() for a in fn(model, ids, mask, tables_to_torch(
        succinct_tables(trie), "cpu")))
    live = s0 > NEG_INF / 2
    assert c1.shape[-1] == max_steps
    np.testing.assert_array_equal(c1[live], c0[live])
    got = stage_retrieve(Workspace(tmp_path / "port"), cfg, model, tok,
                         queries, trie, docids, num_beams=BEAM, topk=TOPK,
                         max_steps=max_steps)
    assert json.loads((tmp_path / "port/run.json").read_text()) == got
    assert list(got) == queries.ids
    for qid in queries.ids:
        g = list(got[qid].items())
        assert [d for d, _ in g] == [d for d, _ in want[qid]]
        scale = max(abs(v) for _, v in want[qid])
        np.testing.assert_allclose([v for _, v in g],
                                   [v for _, v in want[qid]], rtol=1e-5,
                                   atol=1e-5 * scale)

    want16 = jax_stage_retrieve(
        JaxWorkspace(tmp_path / "jax"), ws["jax_cfg"], ws["jax_params"],
        jax_load_tokenizer(Path(ws["root"]) / "tokenizer.json"), queries,
        jtrie, docids, num_beams=BEAM, topk=TOPK, max_steps=max_steps)
    got16 = stage_retrieve(Workspace(tmp_path / "port16"), cfg,
                           _bf16_model(cfg, params, "cpu"), tok, queries,
                           trie, docids, num_beams=BEAM, topk=TOPK,
                           max_steps=max_steps)
    assert list(got16) == list(want16)
    scale = max(abs(v) for docs in want16.values() for v in docs.values())
    for qid, docs in want16.items():
        both = sorted(set(docs) & set(got16[qid]))
        assert len(both) >= len(docs) - 1
        np.testing.assert_allclose([got16[qid][d] for d in both],
                                   [docs[d] for d in both], rtol=2e-2,
                                   atol=2e-2 * scale)


def test_cli_refusals(ws):
    """Without CUDA every subcommand that runs on a device refuses its
    default device before it reads anything."""
    if not torch.cuda.is_available():
        root, qdir = str(ws["root"]), str(ws["qdir"])
        for argv in (["retrieve", *ws["base"]],
                     ["serve", "--workspace", root, "--mode", "dense",
                      "--mmap-dir", root],
                     ["dense-retrieve", "--workspace", root, "--queries",
                      qdir, "--mmap-dir", root],
                     ["index", "--workspace", root, "--docs", qdir],
                     ["aq-index", "--mmap-dir", root, "--out-dir", root]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli(argv)


def test_http_endpoints(ws, tmp_path):
    cfg, params, tok, trie, docids = _port_world(ws)
    eng = RetrievalEngine(cfg, params, tok, trie, docids,
                          ServeConfig(num_beams=BEAM, topk=TOPK,
                                      batch_sizes=(4,), max_delay_ms=20.0,
                                      profile_dir=str(tmp_path / "trace")),
                          device="cpu")
    texts = Collection(ws["qdir"]).texts[:3]
    want = eng.retrieve_batch(texts)
    server = serve_http(eng, port=0, block=False)
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=120)

        def get(path):
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())

        assert get("/healthz") == (200, {"status": "ok"})
        conn.request("POST", "/retrieve", body=json.dumps({"queries": texts}),
                     headers={"Content-Type": "application/json"})
        resp = json.loads(conn.getresponse().read())
        assert [[tuple(x) for x in r] for r in resp["results"]] == want
        status, stats = get("/stats")
        assert status == 200 and stats["served"] >= 2 * len(texts)
        for body in ("not json", json.dumps({"queries": [1]}), "{}"):
            conn.request("POST", "/retrieve", body=body)
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 400
        assert get("/nope")[0] == 404
        assert get("/profile?ms=10")[0] == 403
        assert not (tmp_path / "trace").exists()
        eng.scfg.enable_profile = True
        for bad in ("-5", "nan", "abc", "0"):
            assert get(f"/profile?ms={bad}")[0] == 400
        with port_http._PROFILE_LOCK:
            assert get("/profile?ms=10")[0] == 409
        status, out = get("/profile?ms=20")
        assert status == 200 and out["captured_ms"] == 20.0
        assert out["trace_dir"] == str(tmp_path / "trace")
        assert Path(out["trace"]).parent == tmp_path / "trace"
        assert json.loads(Path(out["trace"]).read_text())
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    assert not eng._thread.is_alive()
