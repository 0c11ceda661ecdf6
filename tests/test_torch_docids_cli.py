"""The port's DocID-build and dense entry points (cli/main.py: index,
merge-embs, aq-index, hnsw-index, dense-retrieve, serve --mode dense, e2e)
on a toy workspace that the JAX package wrote (Orbax params, a
WordTokenizer, a doc collection), against the JAX CLI, on the CPU.

Both CLIs encode in bfloat16, which rounds at other places in the two
frameworks: on this workspace 75 % of the two mmaps' entries differ, by
at most 2 bf16 ulps (0.031 on entries up to 3.6). So the port's mmap is
held to the JAX CLI's within 2e-2 of the rows' scale and equal to the
port's own encoder; the f32 encoders agree within 1e-5
(tests/test_torch_dense.py). With random weights every doc scores within
a few percent of every other (top two often 0.04 % apart), so run.json is
held to the JAX CLI's per doc: the doc sets overlap by 80 %, each shared
doc's scores agree within 2e-2 of the query's score scale, and each run's
top-1 is in the other's top 3. The port's own routes are held to each
other exactly: its encoder's reps are bf16-exact, so the bf16 device
corpus and the f32 host blocks score the same products."""
import http.client
import json
import shutil

import jax
import numpy as np
import pytest

from ripor_tpu.cli.main import main as jax_cli
from ripor_tpu.data import WordTokenizer as JaxWordTokenizer
from ripor_tpu.data.emb_store import open_mmap as jax_open_mmap
from ripor_tpu.evaluation.hnsw import HnswIndex as JaxHnswIndex
from ripor_tpu.models import RiporConfig as JaxRiporConfig
from ripor_tpu.models import T5Config as JaxT5Config
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.quantize import rq_encode as jax_rq_encode
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu_torch import serve as port_serve
from ripor_tpu_torch.cli.main import _bf16_model, _load_workspace_model
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data.datasets import Collection, load_docid_to_smtid
from ripor_tpu_torch.data.emb_store import open_mmap
from ripor_tpu_torch.evaluation.hnsw import HnswIndex
from ripor_tpu_torch.pipeline import load_tokenizer
from ripor_tpu_torch.pipeline.recipe import encode_texts
from ripor_tpu_torch.serve import DenseEngine, ServeConfig

N_DOCS, N_Q, TOPK = 50, 6, 10
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima", "mike", "november"]


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A workspace written by the JAX package, copied for the port; each
    CLI's index (two ranks) and merge-embs of it."""
    tmp = tmp_path_factory.mktemp("torch_docids_cli")
    cfg = JaxRiporConfig(
        t5=JaxT5Config(vocab_size=300, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_decoder_layers=2, num_heads=4,
                       dropout_rate=0.0),
        M=4, K=8)
    jroot = tmp / "jax_ws"
    jax_save_params(jroot / "checkpoints/final",
                    init_ripor_params(jax.random.PRNGKey(0), cfg), cfg)
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(WORDS, 6)) + f" topic{i}"
             for i in range(N_DOCS)]
    JaxWordTokenizer.train(texts + [f"find topic{i}" for i in range(N_DOCS)],
                           vocab_size=300).save(jroot / "tokenizer.json")
    docs = tmp / "docs"
    docs.mkdir()
    (docs / "raw.tsv").write_text(
        "".join(f"d{i}\t{t}\n" for i, t in enumerate(texts)))
    qdir = tmp / "queries"
    qdir.mkdir()
    (qdir / "raw.tsv").write_text("".join(
        f"q{i}\tfind topic{3 * i} {texts[3 * i].split()[0]}\n"
        for i in range(N_Q)))
    proot = tmp / "port_ws"
    shutil.copytree(jroot, proot)
    for run, root, extra in ((jax_cli, jroot, []),
                             (cli, proot, ["--device", "cpu"])):
        for rank in (0, 1):
            run(["index", "--workspace", str(root), "--docs", str(docs),
                 "--rank", str(rank), "--nranks", "2", "--batch-size", "8",
                 "--chunk-size", "10", "--max-length", "16", *extra])
        run(["merge-embs", "--emb-dir", str(root / "embs"),
             "--mmap-dir", str(root / "mmap")])
    return dict(tmp=tmp, jroot=jroot, proot=proot, docs=docs, qdir=qdir)


def _run(path):
    return json.loads(path.read_text())


def _assert_close(got, want):
    """The bf16 bar between the two CLIs' dense runs (module docstring)."""
    assert list(got) == list(want)
    for qid in want:
        g, w = got[qid], want[qid]
        assert len(g) == len(w) == TOPK, qid
        common = set(g) & set(w)
        assert len(common) >= 0.8 * TOPK, qid
        scale = max(abs(s) for s in w.values())
        for d in common:
            assert abs(g[d] - w[d]) <= 2e-2 * scale, (qid, d)
        assert next(iter(g)) in list(w)[:3], qid
        assert next(iter(w)) in list(g)[:3], qid


def _same_up_to_ties(got, want, tol=1e-5):
    """Same qids; per query the scores agree within ``tol`` relative and
    the docids agree wherever the score is not shared with a neighbour."""
    assert list(got) == list(want)
    for qid in want:
        g, w = list(got[qid].items()), list(want[qid].items())
        gs, ws_ = np.array([s for _, s in g]), np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws_, rtol=tol, atol=tol)
        for j, (d, s) in enumerate(w):
            near = np.abs(ws_ - s) <= tol * max(1.0, abs(s))
            if near.sum() == 1:
                assert g[j][0] == d, (qid, j)


def test_index_and_merge_match_jax_cli(ws):
    got, gids = open_mmap(ws["proot"] / "mmap")
    want, wids = jax_open_mmap(ws["jroot"] / "mmap")
    assert gids == wids == [f"d{i}" for i in range(N_DOCS)]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)
    # the rows are the port's own bf16 encoder's, exactly
    _, cfg, params = _load_workspace_model(str(ws["proot"]))
    docs = Collection(ws["docs"])
    np.testing.assert_array_equal(got, encode_texts(
        _bf16_model(cfg, params, "cpu"),
        load_tokenizer(ws["proot"] / "tokenizer.json"), docs.texts, 16, 8))
    # chunked shards of both ranks, as the JAX CLI writes them
    names = sorted(p.name for p in (ws["proot"] / "embs").iterdir())
    assert names == sorted(p.name for p in (ws["jroot"] / "embs").iterdir())
    assert "plan.json" in names and "embs_1_2.npy" in names


def test_aq_index_on_jax_mmap_writes_jax_files(ws):
    mmap = str(ws["jroot"] / "mmap")
    jout, pout = ws["tmp"] / "aq_jax", ws["tmp"] / "aq_port"
    args = ["--mmap-dir", mmap, "--M", "4", "--K", "8", "--kmeans-iters", "5"]
    jax_cli(["aq-index", *args, "--out-dir", str(jout)])
    cli(["aq-index", *args, "--out-dir", str(pout), "--device", "cpu"])
    assert (sorted(p.name for p in pout.iterdir())
            == sorted(p.name for p in jout.iterdir())
            == ["codebooks.npz.npy", "docid_to_smtid.json"])
    books = np.load(pout / "codebooks.npz.npy")
    assert books.shape == (4, 8, 64) and books.dtype == np.float32
    embs, _ = jax_open_mmap(mmap)
    docids, codes = load_docid_to_smtid(pout / "docid_to_smtid.json")
    assert docids == [f"d{i}" for i in range(N_DOCS)]
    np.testing.assert_array_equal(codes, jax_rq_encode(books, embs, beam=4))
    # the streamed route, as aq-index takes it above 1M rows
    sout = ws["tmp"] / "aq_stream"
    cli(["aq-index", *args, "--out-dir", str(sout), "--device", "cpu",
         "--kmeans-batch", "16"])
    _, scodes = load_docid_to_smtid(sout / "docid_to_smtid.json")
    np.testing.assert_array_equal(scodes, jax_rq_encode(
        np.load(sout / "codebooks.npz.npy"), embs, beam=4))


def test_dense_retrieve_routes(ws):
    jroot, proot = ws["jroot"], ws["proot"]
    base = ["--queries", str(ws["qdir"]), "--topk", str(TOPK),
            "--max-length", "16"]
    jax_cli(["dense-retrieve", "--workspace", str(jroot), *base,
             "--mmap-dir", str(jroot / "mmap"),
             "--out", str(jroot / "run_dense.json")])
    runs = {}
    for tag, extra in (("host", []), ("device", ["--device-corpus"]),
                       ("int8", ["--device-corpus", "--corpus-quant",
                                 "int8"])):
        out = proot / f"run_{tag}.json"
        cli(["dense-retrieve", "--workspace", str(proot), *base,
             "--mmap-dir", str(proot / "mmap"), "--out", str(out),
             "--device", "cpu", *extra])
        runs[tag] = _run(out)
    _assert_close(runs["host"], _run(jroot / "run_dense.json"))
    _same_up_to_ties(runs["device"], runs["host"])
    # exact scores of the port's own query reps against the mmap: the host
    # run is their top-k; the int8 run's scores reproduce the exact scores
    # of its docs within tests/test_eval.py's int8 bar
    _, cfg, params = _load_workspace_model(str(proot))
    queries = Collection(ws["qdir"])
    q = encode_texts(_bf16_model(cfg, params, "cpu"),
                load_tokenizer(proot / "tokenizer.json"), queries.texts, 16,
                len(queries), queries=True)
    embs, docids = open_mmap(proot / "mmap")
    exact = q.astype(np.float64) @ np.asarray(embs, np.float64).T
    col = {d: i for i, d in enumerate(docids)}
    for qi, qid in enumerate(queries.ids):
        top = np.argsort(-exact[qi], kind="stable")[:TOPK]
        _same_up_to_ties({qid: runs["host"][qid]},
                         {qid: {docids[j]: exact[qi, j] for j in top}})
        for d, v in runs["int8"][qid].items():
            np.testing.assert_allclose(v, exact[qi, col[d]], rtol=0.05,
                                       atol=0.05)


def test_hnsw_index_and_retrieve(ws):
    proot = ws["proot"]
    index_dir = proot / "hnsw"
    cli(["hnsw-index", "--mmap-dir", str(proot / "mmap"),
         "--index-dir", str(index_dir)])
    out = proot / "run_hnsw.json"
    cli(["dense-retrieve", "--workspace", str(proot), "--queries",
         str(ws["qdir"]), "--topk", str(TOPK), "--max-length", "16",
         "--ann", "hnsw", "--index-dir", str(index_dir), "--out", str(out),
         "--device", "cpu"])
    flat = proot / "run_flat.json"
    cli(["dense-retrieve", "--workspace", str(proot), "--queries",
         str(ws["qdir"]), "--topk", str(TOPK), "--max-length", "16",
         "--mmap-dir", str(proot / "mmap"), "--out", str(flat),
         "--device", "cpu"])
    got, want = _run(out), _run(flat)
    assert list(got) == list(want)
    recall = np.mean([len(set(got[q]) & set(want[q])) / TOPK for q in want])
    assert recall >= 0.9, recall
    # the JAX package reads the port's index files, and searches alike
    embs, docids = open_mmap(proot / "mmap")
    port_idx, jax_idx = HnswIndex.load(index_dir), JaxHnswIndex.load(
        index_dir)
    assert port_idx.is_native == jax_idx.is_native
    assert port_idx.docids == jax_idx.docids == docids
    for a, b in zip(port_idx.search(embs[:5], 5), jax_idx.search(embs[:5], 5)):
        np.testing.assert_array_equal(a, b)


def test_serve_dense_over_http(ws, monkeypatch):
    proot = ws["proot"]
    started = {}

    def serve_http(engine, host="127.0.0.1", port=8600, block=True):
        started["engine"] = engine
        started["server"] = real(engine, host=host, port=0, block=False)
        return started["server"]

    real = port_serve.serve_http
    monkeypatch.setattr(port_serve, "serve_http", serve_http)
    cli(["serve", "--workspace", str(proot), "--mode", "dense",
         "--mmap-dir", str(proot / "mmap"), "--topk", str(TOPK),
         "--batch-sizes", "1", "4", "--device", "cpu"])
    engine, server = started["engine"], started["server"]
    assert isinstance(engine, DenseEngine)
    texts = Collection(ws["qdir"]).texts[:4]
    try:
        host, port = server.server_address
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/retrieve", body=json.dumps({"queries": texts}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = [[tuple(x) for x in r] for r in json.loads(resp.read())
               ["results"]]
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    # an engine built by hand from the same files answers the same
    _, cfg, params = _load_workspace_model(str(proot))
    embs, docids = open_mmap(proot / "mmap")
    eng = DenseEngine(cfg, params, load_tokenizer(proot / "tokenizer.json"),
                      embs, docids,
                      ServeConfig(topk=TOPK, batch_sizes=(1, 4)),
                      device="cpu")
    assert got == [[tuple(x) for x in r] for r in eng.retrieve_batch(texts)]


def _e2e_inputs(tmp):
    """tests/test_pipeline.py::test_e2e_slice's corpus: 40 docs, 12
    queries, one relevant doc each."""
    rng = np.random.default_rng(0)
    docs_dir = tmp / "docs"
    docs_dir.mkdir()
    doc_texts = []
    with open(docs_dir / "raw.tsv", "w") as f:
        for i in range(40):
            text = " ".join(rng.choice(WORDS, 6)) + f" topic{i}"
            doc_texts.append(text)
            f.write(f"d{i}\t{text}\n")
    queries_dir = tmp / "queries"
    queries_dir.mkdir()
    qrel = {}
    with open(queries_dir / "raw.tsv", "w") as f:
        for qi in range(12):
            di = qi * 3
            f.write(f"q{qi}\tfind topic{di} {doc_texts[di].split()[0]}\n")
            qrel[f"q{qi}"] = {f"d{di}": 1}
    (tmp / "qrel.json").write_text(json.dumps(qrel))
    return docs_dir, queries_dir, tmp / "qrel.json", doc_texts


def test_e2e_cli_writes_every_artifact(tmp_path, capsys):
    docs_dir, queries_dir, qrel, doc_texts = _e2e_inputs(tmp_path)
    ws = tmp_path / "ws"
    ws.mkdir()
    from ripor_tpu_torch.data.tokenizer import WordTokenizer
    WordTokenizer.train(doc_texts + ["find"], vocab_size=300).save(
        ws / "tokenizer.json")
    cfg = tmp_path / "e2e.json"
    cfg.write_text(json.dumps({"M": 4, "K": 16, "s2s_epochs": 2,
                               "batch_size": 12, "num_beams": 5,
                               "topk": 20}))
    cli(["e2e", "--workspace", str(ws), "--docs", str(docs_dir),
         "--queries", str(queries_dir), "--qrel", str(qrel),
         "--config", str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    metrics = json.loads(out[out.rindex("{\n"):])
    for name in ("tokenizer.json", "doc_embeds.npy", "text_ids.tsv",
                 "codebooks.npy", "docid_to_smtid.json",
                 "s2s_from_qrel.jsonl", "checkpoints/final/params.pt",
                 "checkpoints/final/config.json", "trie.npz", "run.json",
                 "perf.json"):
        assert (ws / name).exists(), name
    assert json.loads((ws / "perf.json").read_text()) == metrics
    assert set(metrics) == {"mrr_10", "recall_10", "recall_100"}
    assert np.load(ws / "codebooks.npy").shape == (4, 16, 256)
    run = json.loads((ws / "run.json").read_text())
    assert set(run) == {f"q{i}" for i in range(12)}
    assert all(0 < len(r) <= 20 for r in run.values())


@pytest.mark.slow
def test_e2e_slice_reaches_the_jax_bar(tmp_path):
    """tests/test_pipeline.py::test_e2e_slice through the port (CPU)."""
    from ripor_tpu_torch.pipeline.e2e import run_e2e

    docs_dir, queries_dir, qrel, _ = _e2e_inputs(tmp_path)
    metrics = run_e2e(workspace=str(tmp_path / "ws"), docs_dir=str(docs_dir),
                      queries_dir=str(queries_dir), qrel_path=str(qrel),
                      M=4, K=16, vocab_size=300, s2s_epochs=60,
                      learning_rate=2e-3, batch_size=12, num_beams=5,
                      topk=20, device="cpu")
    assert metrics["mrr_10"] > 0.5, metrics
    assert metrics["recall_10"] > 0.5, metrics
