"""The port's training entry points and data on the CPU, against the JAX
package: the collators' batches (tests/test_data.py's tiny data), and
``run_train_from_config`` and the CLI ``train`` on a workspace the JAX
package wrote (a Unigram tokenizer, docid_to_smtid.json, a teacher-score
trainset with prefix scores, an Orbax init_checkpoint both packages read,
a model_config with dropout 0), held against the JAX CLI's ``train``.

Tolerance: params after the two steps: in every tensor at least 99.9 %
of the entries within rtol 1e-5 / atol 1e-6 of the JAX CLI's, and every
entry within 2 * steps * lr (the farthest two updates can move it). Adam
turns a gradient entry near the f32 noise of its sum into an update of up
to lr in either direction, so a few entries of a tensor (one in 4096 seen,
by up to 3.5e-5; the Unigram tokenizer's trainer is not deterministic, so
the data differ from run to run) leave the tight bar. The port's CLI and
its function are equal.
"""
import json

import jax
import numpy as np
import pytest
import torch

from ripor_tpu.cli.main import main as jax_cli
from ripor_tpu.data import UnigramTokenizer as JaxUnigramTokenizer
from ripor_tpu.data import collators as jax_coll
from ripor_tpu.data import datasets as jax_ds
from ripor_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from ripor_tpu.models import RiporConfig as JaxRiporConfig
from ripor_tpu.models import T5Config as JaxT5Config
from ripor_tpu.models.ripor import init_ripor_params
from ripor_tpu.train import save_params as jax_save_params
from ripor_tpu_torch.cli.main import main as cli
from ripor_tpu_torch.data import collators as port_coll
from ripor_tpu_torch.data import datasets as port_ds
from ripor_tpu_torch.data.loader import device_prefetch
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.pipeline.e2e import run_train_from_config
from ripor_tpu_torch.train import load_params
from test_data import tiny_data  # noqa: F401  (the fixture)

M, K, N_DOCS, N_QUERIES = 8, 16, 24, 8


# ---- the collators ----

def _batches(pkg, kind, root):
    """All batches one collator family builds from the tiny data, through
    package ``pkg``'s modules (ds, coll, tokenizer)."""
    ds, coll, tok = pkg
    queries = ds.Collection(root / "queries")
    docs = ds.Collection(root / "docs")
    docids, codes = ds.load_docid_to_smtid(root / "docid_to_smtid.json")
    d2c = dict(zip(docids, codes))
    examples = ds.TeacherScoreExamples(root / "train.jsonl")
    s2s = ds.Seq2SeqExamples(root / "s2s.jsonl")
    mm = coll.MarginMSECollator(tok, queries, d2c, max_length=8,
                                prefix_lengths=(4,))
    if kind == "margin_mse":
        return list(coll.batches_from_teacher_examples(
            examples, mm, batch_size=2, epochs=2))
    if kind == "sharded":
        return [b for r in (0, 1) for b in coll.batches_from_teacher_examples(
            examples, mm, 1, process_index=r, process_count=2)]
    if kind == "resumed":
        return list(coll.batches_from_teacher_examples(
            examples, mm, 1, epochs=2, start_batch=3))
    s2s_coll = coll.Seq2SeqCollator(tok, d2c, max_length=6)
    if kind == "seq2seq":
        return list(coll.batches_from_seq2seq(s2s, s2s_coll, batch_size=1,
                                              epochs=2))
    if kind == "joint":
        rank = coll.batches_from_teacher_examples(examples, mm, 1, epochs=3)
        return list(coll.batches_from_joint(rank, s2s, s2s_coll, 2))
    if kind == "pretrain":
        pc = coll.PretrainCollator(tok, queries, docs, max_length=10,
                                   docid_to_codes=d2c, prefix_len=2)
        return list(coll.batches_from_teacher_examples(examples, pc, 2))
    bce = [("q0", "d0", 1), ("q0", "d2", 0), ("q1", "d1", 1)]
    if kind == "bce_t5seq":
        c = coll.T5SeqBceCollator(tok, queries, d2c, max_length=8)
    else:
        c = coll.BertBceCollator(tok, queries, docs, max_length=12)
    return list(coll.batches_from_bce(bce, c, 2, epochs=2, drop_last=False))


@pytest.mark.parametrize("kind", ["margin_mse", "sharded", "resumed",
                                  "seq2seq", "joint", "pretrain",
                                  "bce_t5seq", "bce_bert"])
def test_collator_batches_equal_jax(tiny_data, kind):  # noqa: F811
    want = _batches((jax_ds, jax_coll, JaxHashTokenizer(500)), kind,
                    tiny_data)
    got = _batches((port_ds, port_coll, HashTokenizer(500)), kind, tiny_data)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_device_prefetch_order_and_cpu():
    batches = [{"x": np.full((2,), i, np.int32)} for i in range(5)]
    out = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert [int(b["x"][0]) for b in out] == list(range(5))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            next(device_prefetch(iter(batches)))


# ---- run_train_from_config and the CLI on a JAX-written workspace ----

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The JAX package's workspace and the JAX CLI's 2-step training of it
    (phase "jax"); returns the paths and a config maker."""
    tmp = tmp_path_factory.mktemp("train_ws")
    ws = tmp / "ws"
    (ws / "checkpoints").mkdir(parents=True)
    rng = np.random.default_rng(0)
    words = [f"word{i}" for i in range(60)]
    texts = [" ".join(rng.choice(words, 6)) for _ in range(N_DOCS)]
    JaxUnigramTokenizer.train(texts, vocab_size=120).save(
        ws / "tokenizer.json")
    docids = [f"d{i}" for i in range(N_DOCS)]
    jax_ds.save_docid_to_smtid(ws / "docid_to_smtid.json", docids,
                               rng.integers(0, K, (N_DOCS, M)))
    for name, ids in (("queries", [f"q{i}" for i in range(N_QUERIES)]),
                      ("docs", docids)):
        (tmp / name).mkdir()
        (tmp / name / "raw.tsv").write_text("".join(
            f"{i}\t{texts[n % N_DOCS]}\n" for n, i in enumerate(ids)))
    with open(tmp / "train.jsonl", "w") as f:
        for q in range(N_QUERIES):
            dd = rng.choice(docids, 4, replace=False).tolist()
            f.write(json.dumps({
                "qid": f"q{q}", "docids": dd,
                "scores": sorted(rng.standard_normal(4).tolist())[::-1],
                "smtid_4_scores": rng.standard_normal(4).tolist()}) + "\n")
    cfg = JaxRiporConfig(
        t5=JaxT5Config(vocab_size=128, d_model=64, d_kv=16, d_ff=128,
                       num_layers=2, num_decoder_layers=2, num_heads=4,
                       dropout_rate=0.0), M=M, K=K)
    cfg.save(tmp / "model_config.json")
    jax_save_params(tmp / "init", init_ripor_params(jax.random.PRNGKey(3),
                                                    cfg), cfg)

    def config(phase, **kw):
        out = {"workspace": str(ws), "queries_dir": str(tmp / "queries"),
               "docs_dir": str(tmp / "docs"),
               "examples_path": str(tmp / "train.jsonl"),
               "loss_type": "t5seq_aq_encoder_lng_knp_margin_mse",
               "model_config": str(tmp / "model_config.json"),
               "init_checkpoint": str(tmp / "init"), "batch_size": 4,
               "max_length": 10, "learning_rate": 1e-3, "total_steps": 10,
               "phase_name": phase, **kw}
        path = tmp / f"{phase}.json"
        path.write_text(json.dumps(out))
        return out, str(path)

    jax_cli(["train", "--config", config("jax")[1]])
    return dict(ws=ws, tmp=tmp, config=config)


def _params(ws, phase):
    return load_params(ws / "checkpoints" / phase)


def test_cli_train_matches_the_jax_cli(workspace, capsys):
    ws = workspace["ws"]
    cli(["train", "--config", workspace["config"]("port_cli")[1],
         "--device", "cpu"])
    timing = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("train_timing ")]
    assert len(timing) == 1
    got, want = _params(ws, "port_cli"), _params(ws, "jax")
    init = load_params(workspace["tmp"] / "init")
    assert set(got) == set(want)
    moved = 0
    for n in want:
        g, w = got[n].numpy(), want[n].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * 2 * 1e-3,
                                   err_msg=n)
        loose = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
        assert loose.mean() <= 1e-3, (n, int(loose.sum()), w.size)
        moved += int(not torch.equal(want[n], init[n]))
    assert moved == len(want)       # two steps moved every parameter


def test_run_train_from_config_equals_the_cli_and_restores(workspace):
    ws = workspace["ws"]
    cfg, _ = workspace["config"]("port_fn")
    got = run_train_from_config(cfg, device="cpu")
    for n, p in _params(ws, "port_cli").items():
        assert torch.equal(got[n], p), n
    # a finished phase is restored, not trained again
    again = run_train_from_config(dict(cfg, learning_rate=0.5),
                                  device="cpu")
    assert all(torch.equal(again[n], got[n]) for n in got)


@pytest.mark.parametrize("loss_type,extra", [
    ("t5seq_pretrain_margin_mse", {"prefix_len": 3}),
    ("t5seq_aq_encoder_ranknet", {}),
])
def test_run_train_from_config_other_branches(workspace, loss_type, extra):
    cfg, _ = workspace["config"](f"port_{loss_type}", loss_type=loss_type,
                                 **extra)
    out = run_train_from_config(cfg, device="cpu")
    init = load_params(workspace["tmp"] / "init")
    assert all(torch.isfinite(v).all() for v in out.values())
    assert not torch.equal(out["encoder.layers.0.attn.q.weight"],
                           init["encoder.layers.0.attn.q.weight"])


def test_seq2seq_branch(workspace):
    tmp = workspace["tmp"]
    with open(tmp / "s2s.jsonl", "w") as f:
        for q in range(N_QUERIES):
            f.write(json.dumps({"docid": f"d{q}", "query": f"word{q}"})
                    + "\n")
    cfg, _ = workspace["config"]("port_s2s",
                                 loss_type="t5seq_aq_encoder_seq2seq",
                                 examples_path=str(tmp / "s2s.jsonl"))
    out = run_train_from_config(cfg, device="cpu")
    assert all(torch.isfinite(v).all() for v in out.values())


def test_train_refusals(workspace):
    """Without CUDA the default device refuses; every loss type trains, the
    teacher and baseline types their own model family (held against the
    JAX package in tests/test_torch_rerank.py)."""
    cfg, path = workspace["config"]("refused")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_train_from_config(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(["train", "--config", path])
    tmp = workspace["tmp"]
    (tmp / "bce.tsv").write_text("".join(
        f"q{q}\td{(q + k) % N_DOCS}\t{int(k == 0)}\n"
        for q in range(N_QUERIES) for k in range(2)))
    family = {"bert_bce": "pooler.weight", "t5seq_bce": "head.Dense_0.weight",
              "margin_mse": "start_embed", "kldiv": "start_embed"}
    for loss_type, key in family.items():
        run = {k: v for k, v in cfg.items() if k != "init_checkpoint"}
        run.update(loss_type=loss_type, phase_name=f"family_{loss_type}",
                   bert_geometry=dict(d_model=32, num_layers=1, num_heads=2,
                                      d_ff=64, max_position=16))
        if loss_type.endswith("bce"):
            run["examples_path"] = str(tmp / "bce.tsv")
        out = run_train_from_config(run, device="cpu")
        assert key in out, (loss_type, sorted(out)[:5])
        assert ("base.codebooks" in out) == (loss_type == "t5seq_bce")
        assert "codebooks" not in out, loss_type
        assert all(torch.isfinite(v).all() for v in out.values()), loss_type
