"""The port's phase-3 flywheel against the JAX package's, on the CPU:
pipeline/datagen.py (a copy: every public function's output EQUAL to
the JAX one's on the same seeded inputs), pipeline/flywheel.py,
train/calibrate.py, pipeline/runner.py and the CLI's ``datagen`` and
``pipeline``.

Bars, as tests/test_torch_cli.py holds the prefix runs:
- ``beam_prefix_candidates`` and ``datagen_round`` in float32: the same
  {qid: {prefix: [docids]}} and the same merged examples as the JAX
  functions with the same params (the port searches on its megarow path,
  the JAX package on its XLA path; exact f32 caches give equal codes). The
  JAX flywheel searches in bf16 by default, so the test patches its module
  to f32; the JAX package itself does not change.
- ``probe_margin_scale``: the same keys, alphas and margin statistics
  within rtol 1e-5; ``calibrate_trainset``'s file within 1e-5.
- CLI ``datagen`` in bf16 on a JAX-written workspace against the JAX
  CLI's files: the beam (32) holds every prefix group of the 30 docs, so
  both packages' D^B is every group whatever the rounding; the same qids
  and smtids, the BERT teacher's f32 scores within 1e-5 relative, the
  self teacher's bf16 scores within rtol 2e-2 of the query's score scale
  (tests/test_torch_cli.py's bf16 bar).
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.cli.main import main as jax_cli
from ripor_tpu.data import HashTokenizer as JaxHashTokenizer
from ripor_tpu.data import TeacherScoreExamples as JaxTeacherScoreExamples
from ripor_tpu.data import WordTokenizer as JaxWordTokenizer
from ripor_tpu.data import save_docid_to_smtid as jax_save_docid_to_smtid
from ripor_tpu.models import RiporConfig as JaxRiporConfig
from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.models import T5Config as JaxT5Config
from ripor_tpu.models.cross_encoder import \
    BertCrossEncoder as JaxBertCrossEncoder
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.pipeline import datagen as jax_dg
from ripor_tpu.pipeline import flywheel as jax_fw
from ripor_tpu.pipeline import runner as jax_runner
from ripor_tpu.train import calibrate as jax_cal
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data.datasets import TeacherScoreExamples
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.pipeline import datagen as dg
from ripor_tpu_torch.pipeline import flywheel as fw
from ripor_tpu_torch.pipeline import runner
from ripor_tpu_torch.train import calibrate as cal
from torch_parity import port_model, port_state_dict
from torch_parity import setup as parity_setup

# ---- datagen.py: a copy, outputs equal ----


def _world(seed=0):
    rng = np.random.default_rng(seed)
    docids = [f"d{i}" for i in range(40)]
    codes = rng.integers(0, 4, (40, 8))
    qids = [f"q{i}" for i in range(6)]
    q2d = {q: [docids[i] for i in rng.choice(40, 12, replace=False)]
           for q in qids}
    p4 = jax_dg.prefix_smtid_strings(codes, docids, 4)
    p8 = jax_dg.prefix_smtid_strings(codes, docids, 8)
    groups = jax_dg.group_docids_by_prefix(q2d, p4)
    scores = {q: {d: float(np.round(rng.normal(), 3)) for d in docids}
              for q in qids}
    rankdata = jax_dg.groups_to_rankdata(groups, scores)
    self_groups = {q: {p4[d]: [d] for d in
                       (docids[i] for i in rng.choice(40, 5, replace=False))}
                   for q in qids}
    self_rank = jax_dg.groups_to_rankdata(self_groups, scores)
    rel = {q: {q2d[q][0]: scores[q][q2d[q][0]]} for q in qids[:5]}
    examples = jax_dg.teacher_run_to_examples(
        {q: {d: scores[q][d] for d in q2d[q]} for q in qids})
    merged = jax_dg.merge_rankdata_with_decay(rankdata, self_rank, 8)
    sym_rank = {q: {d: [[c, scores[q][c]] for c in q2d[q][1:6]]
                    for d in rel[q]} for q in rel}
    pq_rank = {d: {f"pq{i}": float(rng.normal()) for i in range(3)}
               for d in docids[:10]}
    pq_text = {f"pq{i}": f"pseudo query {i}" for i in range(3)}
    qrel = {q: {d: 1 for d in rel[q]} for q in rel}
    run = {q: {d: scores[q][d] for d in q2d[q]} for q in qids}
    return {
        "group_docids_by_prefix": ((q2d, p4), {}),
        "prefix_smtid_strings": ((codes, docids, 3), {}),
        "union_docid_groups": ((groups, self_groups), {}),
        "groups_to_rankdata": ((groups, scores), {}),
        "merge_rankdata_with_decay": ((rankdata, self_rank, 16),
                                      dict(decay=8, keep_top=3)),
        "attach_lng_knp_scores": ((merged, 32), {}),
        "rankdata_to_docid_groups": ((rankdata,), {}),
        "expand_prefix_rankdata": ((rankdata, p8), {}),
        "pseudo_query_examples": ((pq_rank, pq_text), dict(
            score_threshold=0.0)),
        "build_bce_examples": ((qrel, run), dict(
            neg_sample=4, rng=np.random.default_rng(3))),
        "teacher_run_to_examples": ((run,), dict(top_k=5)),
        "qrel_added_teacher_examples": ((examples, rel), {}),
        "nway_labels": ((12,), {}),
        "nway_dataset": ((examples,), dict(nway=11)),
        "truncate_examples": ((jax_dg.attach_lng_knp_scores(merged, 8), 3),
                              {}),
        "qrel_first_examples": ((rel, p4, rankdata, 4), {}),
        "merge_self_neg_sym_neg": ((sym_rank, rel, rankdata, p4, 4),
                                   dict(threshold=4)),
        "add_qrel_examples": ((rel, p4, rankdata, 8), dict(decay=1)),
        "_smtid_scores": ((rankdata["q0"], 0.75), {}),
    }


PUBLIC = sorted(_world())


def test_datagen_covers_every_function():
    names = {n for n, f in vars(jax_dg).items()
             if callable(f) and getattr(f, "__module__", None)
             == jax_dg.__name__}
    assert names == set(PUBLIC)
    assert dg.DECAY_TO_FACTOR == jax_dg.DECAY_TO_FACTOR
    assert dg.MNT_TO_SMTID_FACTOR == jax_dg.MNT_TO_SMTID_FACTOR


@pytest.mark.parametrize("name", PUBLIC)
def test_datagen_equals_jax(name):
    args, kw = _world()[name]
    want = getattr(jax_dg, name)(*args, **kw)
    # a fresh copy of the inputs (the rng argument is consumed)
    args, kw = _world()[name]
    got = getattr(dg, name)(*args, **kw)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


# ---- flywheel.py ----

M, K = 8, 8
QIDS = [f"q{i}" for i in range(5)]
QTEXTS = ["alpha beta", "gamma", "delta epsilon zeta", "eta theta", "iota"]
BEAMS, BATCH = 6, 2


@pytest.fixture(scope="module")
def toy():
    """The toy model (both packages, f32), codes, and the JAX flywheel's
    beam_prefix_candidates in f32, memoized so that each prefix length
    compiles one JAX beam search for the whole file."""
    cfg, params, _, _, doc_codes = parity_setup(M=M, K=K, n_docs=40)
    docids = [f"d{i}" for i in range(40)]
    jax_f32 = functools.partial(jax_fw.beam_prefix_candidates,
                                dtype=jnp.float32)
    memo = {}

    def jax_beam(cfg_, params_, tok, qids, texts, codes, dids, prefix_len,
                 num_beams=100, batch_size=4, max_length=64, **kw):
        key = (prefix_len, tuple(qids), num_beams, batch_size)
        if key not in memo:
            memo[key] = jax_f32(cfg_, params_, tok, qids, texts, codes, dids,
                                prefix_len=prefix_len, num_beams=num_beams,
                                batch_size=batch_size,
                                max_length=max_length, **kw)
        return memo[key]

    return dict(cfg=cfg, params=params, model=port_model(params, cfg),
                codes=doc_codes, docids=docids, jax_beam=jax_beam)


@pytest.mark.parametrize("prefix_len", [2, 4, M])
def test_beam_prefix_candidates_matches_jax(toy, prefix_len):
    """f32 on both sides: the same prefixes and documents per query, over
    five queries in batches of two (the last padded with "")."""
    want = toy["jax_beam"](toy["cfg"], toy["params"], JaxHashTokenizer(100),
                           QIDS, QTEXTS, toy["codes"], toy["docids"],
                           prefix_len, num_beams=BEAMS, batch_size=BATCH)
    got = fw.beam_prefix_candidates(
        toy["cfg"], toy["model"], HashTokenizer(100), QIDS, QTEXTS,
        toy["codes"], toy["docids"], prefix_len=prefix_len,
        num_beams=BEAMS, batch_size=BATCH, dtype=torch.float32,
        device="cpu")
    assert got == want
    assert all(len(b) == BEAMS for b in got.values())
    for bucket in got.values():
        for prefix, docs in bucket.items():
            assert len(prefix.split("_")) == prefix_len
            for d in docs:
                row = toy["codes"][int(d[1:]), :prefix_len]
                assert "_".join(map(str, row)) == prefix


def test_search_model_reuses_or_casts(toy):
    m = toy["model"]
    assert fw.search_model(toy["cfg"], m, torch.float32, "cpu") is m
    bf = fw.search_model(toy["cfg"], m, torch.bfloat16, "cpu")
    assert bf is not m and bf.dtype == torch.bfloat16
    sd = port_state_dict(toy["params"], toy["cfg"])
    again = fw.search_model(toy["cfg"], sd, torch.float32, "cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, m.state_dict()[k]), k


def _det_pairs(pairs, query_texts=None):
    """A deterministic stand-in teacher: {qid: {docid: score}}."""
    out = {}
    for q, d in pairs:
        out.setdefault(q, {})[d] = ((int(q[1:]) * 131 + int(d[1:]) * 17)
                                    % 101) / 7.0
    return out


@pytest.mark.parametrize("prefix_len", [4, M])
def test_datagen_round_matches_jax(toy, monkeypatch, prefix_len):
    """The same merged examples (and raw union rankdata and pair scores)
    as the JAX datagen_round with its beam patched to f32, and the port's
    beam likewise."""
    monkeypatch.setattr(jax_fw, "beam_prefix_candidates", toy["jax_beam"])
    monkeypatch.setattr(fw, "beam_prefix_candidates", functools.partial(
        fw.beam_prefix_candidates, dtype=torch.float32))
    rng = np.random.default_rng(prefix_len)
    q2d = {q: [toy["docids"][i] for i in rng.choice(40, 6, replace=False)]
           for q in QIDS}
    queries = dict(zip(QIDS, QTEXTS))
    kw = dict(prefix_len=prefix_len, num_beams=BEAMS, batch_size=BATCH,
              return_intermediates=True)
    want = jax_fw.datagen_round(toy["cfg"], toy["params"],
                                JaxHashTokenizer(100), queries, q2d,
                                toy["codes"], toy["docids"], _det_pairs,
                                **kw)
    got = fw.datagen_round(toy["cfg"], toy["model"], HashTokenizer(100),
                           queries, q2d, toy["codes"], toy["docids"],
                           _det_pairs, device="cpu", **kw)
    assert got == want
    merged = got[0]
    assert {ex["qid"] for ex in merged} == set(QIDS)
    if prefix_len > 4:
        assert all("smtid_4_scores" in ex for ex in merged)


def test_create_trainset_and_jsonl_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    run = {f"q{i}": {f"d{j}": float(rng.normal()) for j in range(i + 1)}
           for i in range(5)}
    qrel = {"q2": {"d1": 1}, "q3": {"d9": 1}, "q4": {"d0": 0}}
    for q, k in ((None, 100), (qrel, 100), (qrel, 2)):
        want = jax_fw.create_trainset(run, q, top_k=k)
        got = fw.create_trainset(run, q, top_k=k)
        assert got == want
    fw.write_jsonl(str(tmp_path / "port.jsonl"), got)
    jax_fw.write_jsonl(str(tmp_path / "jax.jsonl"), want)
    assert ((tmp_path / "port.jsonl").read_bytes()
            == (tmp_path / "jax.jsonl").read_bytes())
    assert fw.read_jsonl(str(tmp_path / "jax.jsonl")) == want
    assert jax_fw.read_jsonl(str(tmp_path / "port.jsonl")) == got


# ---- train/calibrate.py ----

def _close_stats(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _close_stats(got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.fixture(scope="module")
def smtid_trainset(toy, tmp_path_factory):
    """A prefix-8 lng_knp trainset (smtids as docids, smtid_4 column)."""
    path = tmp_path_factory.mktemp("cal") / "lng_knp_8.jsonl"
    p8 = jax_dg.prefix_smtid_strings(toy["codes"], toy["docids"], 8)
    rng = np.random.default_rng(2)
    rows = []
    for q in QIDS:
        ds = rng.choice(40, 6, replace=False)
        sc = sorted(rng.normal(size=6) * 3, reverse=True)
        rows.append({"qid": q, "smtids": [p8[f"d{i}"] for i in ds],
                     "scores": [float(s) for s in sc]})
    jax_fw.write_jsonl(str(path), jax_dg.attach_lng_knp_scores(rows, 8))
    return path


def test_probe_margin_scale_matches_jax(toy, smtid_trainset):
    queries = dict(zip(QIDS, QTEXTS))
    kw = dict(prefix_lengths=(4,), n=32, batch_size=16, seed=3)
    want = jax_cal.probe_margin_scale(
        JaxRiporModel(toy["cfg"]), toy["params"], JaxHashTokenizer(100),
        queries, JaxTeacherScoreExamples(smtid_trainset,
                                         smtid_as_docid=True), **kw)
    got = cal.probe_margin_scale(
        toy["model"], None, HashTokenizer(100), queries,
        TeacherScoreExamples(smtid_trainset, smtid_as_docid=True), **kw)
    assert set(got) == {"alpha", "alpha_4", "student_margin_mean",
                        "student_margin_std", "teacher_margin_mean",
                        "teacher_margin_std", "n"}
    _close_stats(got, want)


def test_calibrate_trainset_matches_jax(toy, tmp_path):
    """Docid mode (docid_to_codes), as phase-2 MarginMSE calibrates."""
    rng = np.random.default_rng(4)
    rows = [{"qid": q, "docids": [f"d{i}" for i in
                                  rng.choice(40, 5, replace=False)],
             "scores": sorted((float(s) for s in rng.normal(size=5) * 2),
                              reverse=True)} for q in QIDS]
    src = tmp_path / "mm.jsonl"
    jax_fw.write_jsonl(str(src), rows)
    d2c = dict(zip(toy["docids"], toy["codes"]))
    queries = dict(zip(QIDS, QTEXTS))
    kw = dict(docid_to_codes=d2c, smtid_as_docid=False, n=16, seed=0)
    want = jax_cal.calibrate_trainset(
        str(src), str(tmp_path / "jax.cal.jsonl"), JaxRiporModel(toy["cfg"]),
        toy["params"], JaxHashTokenizer(100), queries,
        alphas_out=str(tmp_path / "jax_alphas.json"), **kw)
    got = cal.calibrate_trainset(
        str(src), str(tmp_path / "port.cal.jsonl"), toy["model"],
        port_state_dict(toy["params"], toy["cfg"]), HashTokenizer(100),
        queries, alphas_out=str(tmp_path / "port_alphas.json"), **kw)
    _close_stats(got, want)
    _close_stats(json.loads((tmp_path / "port_alphas.json").read_text()),
                 json.loads((tmp_path / "jax_alphas.json").read_text()))
    g = fw.read_jsonl(str(tmp_path / "port.cal.jsonl"))
    w = fw.read_jsonl(str(tmp_path / "jax.cal.jsonl"))
    assert [(r["qid"], r["docids"]) for r in g] == [
        (r["qid"], r["docids"]) for r in w]
    for a, b in zip(g, w):
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5)
    rows2, applied = cal.calibrate_rows(rows, {"alpha": 2.0, "alpha_4": 0.5})
    assert (rows2, applied) == jax_cal.calibrate_rows(
        rows, {"alpha": 2.0, "alpha_4": 0.5})


# ---- pipeline/runner.py ----

def test_pipeline_runner_resume(tmp_path):
    """tests/test_pipeline.py::test_pipeline_runner_resume through the
    port: stages run once, skip when complete, re-run via from_stage, and
    fail on missing declared outputs."""
    calls = []
    out_a = tmp_path / "a.txt"

    def fake_cli(argv):
        calls.append(argv[0])
        if argv[0] == "a":
            out_a.write_text("x")

    spec = {"workspace": str(tmp_path), "stages": [
        {"name": "a", "argv": ["a"], "outputs": [str(out_a)]},
        {"name": "b", "argv": ["b"]},
    ]}
    quiet = dict(cli_main=fake_cli, log=lambda m: None)
    assert runner.run_pipeline(spec, **quiet) == ["a", "b"]
    assert calls == ["a", "b"]
    assert runner.run_pipeline(spec, **quiet) == []
    out_a.unlink()
    assert runner.run_pipeline(spec, **quiet) == ["a"]
    assert runner.run_pipeline(spec, from_stage="b", **quiet) == ["b"]
    with pytest.raises(ValueError, match="unknown stage"):
        runner.run_pipeline(spec, from_stage="z", **quiet)
    with pytest.raises(ValueError, match="duplicate"):
        runner.run_pipeline({"workspace": str(tmp_path), "stages": [
            {"name": "a", "argv": ["a"]}, {"name": "a", "argv": ["a"]}]},
            **quiet)
    bad = {"workspace": str(tmp_path / "bad"), "stages": [
        {"name": "c", "argv": ["c"], "outputs": [str(tmp_path / "never")]}]}
    with pytest.raises(RuntimeError, match="outputs missing"):
        runner.run_pipeline(bad, **quiet)


def test_jax_manifest_resumes_in_the_port(tmp_path):
    """A manifest the JAX runner wrote is the port's: its stages skip,
    and from_stage invalidates the same entries in the same file."""
    out = tmp_path / "o.txt"
    calls = []

    def fake_cli(argv):
        calls.append(argv[0])
        out.write_text("x")

    spec = {"workspace": str(tmp_path), "stages": [
        {"name": "a", "argv": ["a"], "outputs": [str(out)]},
        {"name": "b", "argv": ["b"]}, {"name": "c", "argv": ["c"]}]}
    assert jax_runner.run_pipeline(spec, cli_main=fake_cli,
                                   log=lambda m: None) == ["a", "b", "c"]
    written = json.loads((tmp_path / "pipeline_manifest.json").read_text())
    assert runner.PipelineManifest(tmp_path).completed == written
    assert runner.run_pipeline(spec, cli_main=fake_cli,
                               log=lambda m: None) == []
    assert runner.run_pipeline(spec, cli_main=fake_cli, from_stage="b",
                               log=lambda m: None) == ["b", "c"]
    assert jax_runner.run_pipeline(spec, cli_main=fake_cli,
                                   log=lambda m: None) == []
    assert calls == ["a", "b", "c", "b", "c"]


def test_runner_defaults_to_the_ports_cli(tmp_path, capsys):
    qrel = tmp_path / "qrel.json"
    qrel.write_text(json.dumps({"q": {"a": 1}}))
    (tmp_path / "run.json").write_text(json.dumps({"q": {"b": 2.0,
                                                         "a": 1.0}}))
    spec = {"workspace": str(tmp_path), "stages": [
        {"name": "eval", "argv": ["evaluate", "--qrel", str(qrel), "--run",
                                  str(tmp_path / "run.json")]}]}
    assert runner.run_pipeline(spec, log=lambda m: None) == ["eval"]
    assert json.loads(capsys.readouterr().out) == {"mrr_10": 0.5}


# ---- CLI datagen and pipeline on a JAX-written workspace ----

N_DOCS, N_QUERIES, CLI_M, CLI_K, CLI_BEAM = 30, 5, 8, 16, 32
BERT_GEO = dict(d_model=32, num_layers=2, num_heads=4, d_ff=64,
                max_position=64, dropout=0.0)
PLENS = {"self": (4, 8), "bert": (8,)}


@pytest.fixture(scope="module")
def cli_ws(tmp_path_factory):
    """A JAX-written workspace (Orbax RIPOR params, WordTokenizer, codes),
    queries, docs, a teacher trainset, a BertCrossEncoder teacher (Orbax
    + bert_geometry.json), and the JAX CLI's datagen files for both
    teachers at prefix lengths 4 and 8."""
    tmp = tmp_path_factory.mktemp("datagen_cli")
    ws = tmp / "ws"
    cfg = JaxRiporConfig(
        t5=JaxT5Config(vocab_size=300, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_decoder_layers=2, num_heads=4,
                       dropout_rate=0.0),
        M=CLI_M, K=CLI_K)
    jax_save_params(ws / "checkpoints/final",
                    init_ripor_params(jax.random.PRNGKey(0), cfg), cfg)
    texts = [f"document number {i} about subject {i % 7}"
             for i in range(N_DOCS)]
    tok = JaxWordTokenizer.train(texts, vocab_size=300)
    tok.save(ws / "tokenizer.json")
    codes = np.random.default_rng(0).integers(0, CLI_K, (N_DOCS, CLI_M))
    jax_save_docid_to_smtid(ws / "docid_to_smtid.json",
                            [f"d{i}" for i in range(N_DOCS)], codes)
    (tmp / "queries").mkdir()
    (tmp / "queries" / "raw.tsv").write_text("".join(
        f"q{i}\tsubject {i} document {i % 3}\n" for i in range(N_QUERIES)))
    (tmp / "docs").mkdir()
    (tmp / "docs" / "raw.tsv").write_text("".join(
        f"d{i}\t{t}\n" for i, t in enumerate(texts)))
    rng = np.random.default_rng(1)
    jax_fw.write_jsonl(str(tmp / "teacher.jsonl"), [
        {"qid": f"q{i}", "docids": [f"d{j}" for j in
                                    rng.choice(N_DOCS, 6, replace=False)],
         "scores": list(range(6, 0, -1))} for i in range(N_QUERIES)])
    ids = jnp.ones((1, 8), jnp.int32)
    jax_save_params(tmp / "teacher", JaxBertCrossEncoder(
        vocab_size=tok.vocab_size, **BERT_GEO).init(
        {"params": jax.random.PRNGKey(6)}, ids, ids)["params"])
    (tmp / "teacher" / "bert_geometry.json").write_text(json.dumps(BERT_GEO))
    base = ["datagen", "--workspace", str(ws), "--queries",
            str(tmp / "queries"), "--teacher-trainset",
            str(tmp / "teacher.jsonl"), "--prefix-lengths", "4", "8",
            "--beam", str(CLI_BEAM)]
    bert = ["--teacher", "bert", "--teacher-ckpt", str(tmp / "teacher"),
            "--docs", str(tmp / "docs")]
    # the BERT teacher at prefix 8 only: one JAX beam compile fewer
    bert += ["--prefix-lengths", "8"]
    jax_files = {}
    for teacher, extra in (("self", []), ("bert", bert)):
        jax_cli(base + extra)
        jax_files[teacher] = {p: _read(ws, p) for p in PLENS[teacher]}
    return dict(tmp=tmp, ws=ws, base=base, bert=bert, jax=jax_files)


def _read(ws, p):
    return fw.read_jsonl(
        str(Path(ws) / f"lng_knp_qid_smtids_scores_{p}.train.json"))


def _by_smtid(examples):
    return {ex["qid"]: {k: dict(zip(ex["smtids"], ex[k])) for k in ex
                        if k.endswith("scores")} for ex in examples}


@pytest.mark.parametrize("teacher", ["self", "bert"])
def test_cli_datagen_matches_jax_cli(cli_ws, teacher, capsys):
    extra = cli_ws["bert"] if teacher == "bert" else []
    cli(cli_ws["base"] + extra + ["--device", "cpu"])
    timing = [json.loads(line.split(" ", 1)[1]) for line in
              capsys.readouterr().out.splitlines()
              if line.startswith("datagen_timing")]
    assert [t["prefix_len"] for t in timing] == list(PLENS[teacher])
    assert all(t["pairs_scored"] > 0 for t in timing)
    for p in PLENS[teacher]:
        got = _by_smtid(_read(cli_ws["ws"], p))
        want = _by_smtid(cli_ws["jax"][teacher][p])
        assert list(got) == list(want)
        for qid, cols in want.items():
            assert set(got[qid]) == set(cols)
            assert ("smtid_4_scores" in cols) == (p > 4)
            for col, w in cols.items():
                assert list(got[qid][col]) and set(got[qid][col]) == set(w)
                assert all(len(s.split("_")) == p for s in w)
                g = [got[qid][col][s] for s in w]
                w = list(w.values())
                if teacher == "bert":
                    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
                else:
                    scale = max(abs(x) for x in w)
                    np.testing.assert_allclose(g, w, rtol=2e-2,
                                               atol=2e-2 * scale)


def test_cli_datagen_bert_needs_its_flags(cli_ws):
    with pytest.raises(SystemExit, match="teacher-ckpt"):
        cli(cli_ws["base"] + ["--teacher", "bert", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--docs"):
        cli(cli_ws["base"] + ["--teacher", "bert", "--teacher-ckpt",
                              str(cli_ws["tmp"] / "teacher"),
                              "--device", "cpu"])


def test_cli_pipeline_resumes_and_equals_direct_runs(cli_ws, tmp_path,
                                                     capsys):
    """retrieve -> evaluate -> datagen as a pipeline spec with --device
    cpu: the second run runs nothing, --from evaluate re-runs the last
    two, and each output equals the subcommand run directly."""
    import shutil
    ws = tmp_path / "ws"
    shutil.copytree(cli_ws["ws"], ws, ignore=shutil.ignore_patterns(
        "lng_knp_*", "run*.json"))
    qrel = tmp_path / "qrel.json"
    qrel.write_text(json.dumps({f"q{i}": {f"d{i}": 1}
                                for i in range(N_QUERIES)}))
    retrieve = ["retrieve", "--workspace", str(ws), "--queries",
                str(cli_ws["tmp"] / "queries"), "--beam", "8", "--topk",
                "8"]
    evaluate = ["evaluate", "--qrel", str(qrel), "--run",
                str(ws / "run.json")]
    datagen = [a if a != str(cli_ws["ws"]) else str(ws)
               for a in cli_ws["base"]]
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"workspace": str(ws), "stages": [
        {"name": "retrieve", "argv": retrieve,
         "outputs": [str(ws / "run.json")]},
        {"name": "evaluate", "argv": evaluate},
        {"name": "datagen", "argv": datagen, "outputs": [
            str(ws / "lng_knp_qid_smtids_scores_8.train.json")]}]}))
    cmd = ["pipeline", "--config", str(spec), "--device", "cpu"]
    cli(cmd)
    out = capsys.readouterr().out
    assert "pipeline complete (3 stages ran)" in out
    mrr = json.loads(out[out.index("{\n"):out.index("\n}") + 2])
    files = {n: (ws / n).read_text() for n in (
        "run.json", "lng_knp_qid_smtids_scores_4.train.json",
        "lng_knp_qid_smtids_scores_8.train.json")}
    cli(cmd)
    assert "pipeline complete (0 stages ran)" in capsys.readouterr().out
    cli(cmd + ["--from", "evaluate"])
    assert "pipeline complete (2 stages ran)" in capsys.readouterr().out
    for argv in (retrieve, datagen):
        cli(argv + ["--device", "cpu"])
    capsys.readouterr()
    cli(evaluate)
    assert json.loads(capsys.readouterr().out) == mrr
    for n, text in files.items():
        assert (ws / n).read_text() == text, n
