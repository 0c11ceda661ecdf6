"""The stages of the recipe, over a workspace directory.

Port of ripor_tpu/pipeline/recipe.py: ``Workspace``, ``load_tokenizer``
and every stage (tokenizer, corpus encode, RQ DocIDs, codebook install,
trie, train, retrieve, evaluate), with the JAX package's file names. The
workspace layout is the reference's:

  workspace/
    tokenizer.json            (WordTokenizer or Unigram tokenizer)
    doc_embeds.npy            (reference: doc_embeds.mmap, evaluator.py:664-677)
    text_ids.tsv              (doc order of the embedding matrix)
    codebooks.npy             (reference: faiss rq.codebooks)
    docid_to_smtid.json       (reference format incl. -1 sentinel)
    trie.npz                  (the DocIdTrie's arrays)
    checkpoints/<phase>/      (params + config; train/checkpoint.py)
    run.json / perf.json      (trec run and metrics)

Stages are re-entrant: they skip work when their artifact already exists.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ripor_tpu_torch.core.mesh import barrier, is_first_process
from ripor_tpu_torch.data.datasets import (Collection, load_docid_to_smtid,
                                           save_docid_to_smtid)
from ripor_tpu_torch.data.tokenizer import (TextTokenizer, UnigramTokenizer,
                                            WordTokenizer, tokenize_docs,
                                            tokenize_queries)
from ripor_tpu_torch.decode.beam import (expand_groups_to_docids,
                                         make_beam_search_fn)
from ripor_tpu_torch.decode.quant_gate import ensure_quant_validated
from ripor_tpu_torch.evaluation.metrics import evaluate_run
from ripor_tpu_torch.evaluation.retriever import encode_corpus
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.ripor import install_codebooks
from ripor_tpu_torch.quantize.rq import RQCodebooks, rq_encode, train_rq
from ripor_tpu_torch.train.checkpoint import (has_params, load_params,
                                              save_params)
from ripor_tpu_torch.train.trainer import TrainConfig, Trainer
from ripor_tpu_torch.trie.build import DocIdTrie, build_trie
from ripor_tpu_torch.trie.succinct import succinct_tables, tables_to_torch


class Workspace:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, name: str) -> Path:
        return self.root / name

    def has(self, name: str) -> bool:
        return self.path(name).exists()

    def log(self, msg: str) -> None:
        print(f"[pipeline {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def load_tokenizer(path) -> TextTokenizer:
    """Load a saved tokenizer, dispatching on file content: WordTokenizer
    files carry {"kind": "word"}, anything else is a ``tokenizers`` JSON
    (which needs the ``tokenizers`` package)."""
    try:
        obj = json.loads(Path(path).read_text())
    except (ValueError, UnicodeDecodeError):
        obj = None
    if isinstance(obj, dict) and obj.get("kind") == "word":
        return WordTokenizer.load(path)
    return UnigramTokenizer.load(path)


def stage_tokenizer(ws: Workspace, corpus_texts: Iterable[str],
                    vocab_size: int = 32000,
                    kind: str = "unigram") -> TextTokenizer:
    """``kind``: "unigram" (production; SentencePiece-family, its trainer
    is nondeterministic and needs the ``tokenizers`` package) or "word"
    (deterministic — recipes that gate on exact metrics). An existing
    tokenizer.json is loaded instead."""
    if ws.has("tokenizer.json"):
        return load_tokenizer(ws.path("tokenizer.json"))
    ws.log(f"training tokenizer ({kind})")
    if kind == "word":
        tok = WordTokenizer.train(corpus_texts, vocab_size=vocab_size)
    elif kind == "unigram":
        tok = UnigramTokenizer.train(corpus_texts, vocab_size=vocab_size)
    else:
        raise ValueError(f"unknown tokenizer kind {kind!r}")
    tok.save(ws.path("tokenizer.json"))
    return tok


def encode_texts(model, tok: TextTokenizer, texts: Sequence[str],
                 max_length: int, batch_size: int,
                 queries: bool = False) -> np.ndarray:
    """Dense reps [len(texts), d] float32 of docs (or, with ``queries``,
    of queries: the tokenizer's query prefix) by ``model.dense_rep`` in
    fixed-shape batches, the last padded with empty texts whose rows are
    dropped."""
    tokenize = tokenize_queries if queries else tokenize_docs

    def batches():
        for s in range(0, len(texts), batch_size):
            part = list(texts[s:s + batch_size])
            ids, mask = tokenize(
                tok, part + [""] * (batch_size - len(part)), max_length)
            yield {"input_ids": ids, "attention_mask": mask,
                   "n_valid": len(part)}
    return encode_corpus(model, batches())


def stage_encode_corpus(ws: Workspace, model, docs: Collection,
                        tok: TextTokenizer, max_length: int = 128,
                        batch_size: int = 64,
                        out_name: str = "doc_embeds.npy") -> np.ndarray:
    """Dense-encode all docs with ``model.dense_rep`` (a RiporModel, in its
    dtype on its device) -> [N, d] float32, saved as ``out_name`` with
    text_ids.tsv (reference DenseIndexing + mmap merge, evaluate.py:184-227).
    ``out_name`` distinguishes encodes by different checkpoints; an
    existing file is loaded instead."""
    if ws.has(out_name):
        return np.load(ws.path(out_name))
    ws.log(f"encoding {len(docs)} docs -> {out_name}")
    embs = encode_texts(model, tok, docs.texts, max_length, batch_size)
    np.save(ws.path(out_name), embs)
    with open(ws.path("text_ids.tsv"), "w") as f:
        for i, did in enumerate(docs.ids):
            f.write(f"{i}\t{did}\n")
    return embs


def stage_build_docids(ws: Workspace, embs, docids: Sequence[str],
                       M: int, K: int, kmeans_iters: int = 25,
                       encode_beam: int = 4,
                       generator: torch.Generator = None,
                       device=None) -> np.ndarray:
    """RQ codebooks + codes -> docid_to_smtid.json + codebooks.npy
    (reference all_aq_pipline steps 3,5,6; SURVEY.md §3.4), on ``device``
    (default "cuda"); ``generator`` as in quantize.rq.train_rq. When both
    files exist, the codes are read back instead."""
    if ws.has("docid_to_smtid.json") and ws.has("codebooks.npy"):
        _, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
        return codes
    ws.log(f"training RQ {M}x{K} on {tuple(embs.shape)}")
    books = train_rq(embs, M=M, K=K, kmeans_iters=kmeans_iters,
                     generator=generator, device=device)
    books.save(ws.path("codebooks.npy"))
    codes = rq_encode(books, embs, beam=encode_beam, device=device)
    save_docid_to_smtid(ws.path("docid_to_smtid.json"), list(docids), codes)
    uniq = len({tuple(r) for r in codes.tolist()})
    ws.log(f"codes built: {uniq}/{len(codes)} unique smtids")
    return codes


def stage_install_codebooks(ws: Workspace, params,
                            shared_output_input_embeds: bool = True):
    """codebooks.npy into ``params`` (a state_dict or a RiporModel:
    models/ripor.py::install_codebooks)."""
    books = RQCodebooks.load(ws.path("codebooks.npy"))
    return install_codebooks(params, books.codebooks,
                             shared_output_input_embeds)


def stage_build_trie(ws: Workspace, codes: np.ndarray, K: int) -> DocIdTrie:
    if ws.has("trie.npz"):
        return DocIdTrie.load(ws.path("trie.npz"))
    ws.log("building trie")
    trie = build_trie(codes, K)
    trie.save(ws.path("trie.npz"))
    ws.log(f"trie: {trie.num_internal} internal, {trie.num_groups} groups, "
           f"{trie.memory_bytes() / 1e6:.1f} MB")
    return trie


def stage_train(ws: Workspace, phase_name: str, model, params,
                tcfg: TrainConfig, batches: Iterable[Dict],
                cfg: Optional[RiporConfig], rng_seed: int = 0, mesh=None,
                anchor_params=None) -> Dict:
    """Train one phase -> its params (a state_dict of CPU tensors), saved
    to ``checkpoints/<phase_name>`` (params.pt, and config.json when
    ``cfg`` is given). An existing checkpoint there (params.pt, or the JAX
    package's Orbax tree) is restored instead. ``model``: the model to
    train, on its device — a RiporModel (``cfg`` its config) or a teacher
    or baseline model (``cfg`` None for the BERT families, as the JAX
    package passes it). ``mesh``: train data-parallel (every rank calls
    stage_train with the same params and batches; the first rank writes
    the checkpoint)."""
    ckpt_dir = ws.path(f"checkpoints/{phase_name}")
    if has_params(ckpt_dir):
        ws.log(f"{phase_name}: restoring existing checkpoint")
        return load_params(ckpt_dir, cfg, model=model)
    ws.log(f"{phase_name}: training")
    trainer = Trainer(model, tcfg, params, mesh=mesh,
                      anchor_params=anchor_params,
                      log_fn=lambda m, s: ws.log(f"{phase_name} step {s}: "
                                                 f"loss={m['loss']:.4f}"))
    state, _ = trainer.run(batches, rng_seed)
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    if mesh is None or is_first_process():
        save_params(ckpt_dir, params, cfg)
    if mesh is not None:
        barrier()
    return params


def stage_retrieve(ws: Workspace, cfg: RiporConfig, model,
                   tok: TextTokenizer, queries: Collection, trie: DocIdTrie,
                   docids: Sequence[str], num_beams: int = 10,
                   topk: int = 100, max_length: int = 64, batch_size: int = 8,
                   run_name: str = "run.json", kv_cache_int8: bool = False,
                   kv_cache_quant: str = None, max_steps: int = None,
                   ffn_int8: bool = None,
                   ckpt_dir=None) -> Dict[str, Dict[str, float]]:
    """Constrained-beam retrieval over all queries -> trec run dict, also
    written to ``ws/run_name`` (reference t5seq_aq_retrieve_docids,
    evaluate.py:396-526).

    ``model``: a RiporModel; the search runs in its dtype on its device.
    Queries go in batches of ``batch_size``, the last padded with empty
    queries. ``kv_cache_int8``/``kv_cache_quant``: quantized decode cache
    (see make_beam_search_fn; "int4" packs nibble rows). ``max_steps`` < M
    decodes a PREFIX run: pass a trie built from prefix-truncated codes —
    the sub-smtid retrieval the paper's prefix-oriented claim is measured
    on (reference t5seq_aq_retrieve_docids_use_sub_smtid). ``ffn_int8``
    (None = off) is preflighted through decode.quant_gate against
    ``ckpt_dir``'s recorded validation: an unvalidated ffn_int8 combination
    refuses instead of silently perturbing the run."""
    ffn_int8 = bool(ffn_int8)
    ensure_quant_validated(kv_cache_quant
                           or ("int8" if kv_cache_int8 else None),
                           ffn_int8, ckpt_dir=ckpt_dir)
    device = next(model.parameters()).device
    fn = make_beam_search_fn(cfg, num_beams, constrained=True,
                             dtype=model.dtype, kv_cache_int8=kv_cache_int8,
                             kv_cache_quant=kv_cache_quant,
                             max_steps=max_steps, ffn_int8=ffn_int8,
                             device=device)
    tables = tables_to_torch(succinct_tables(trie), device)
    run: Dict[str, Dict[str, float]] = {}
    n = len(queries)
    for s in range(0, n, batch_size):
        texts = [queries.text_at(i) for i in range(s, min(s + batch_size, n))]
        pad = batch_size - len(texts)
        ids, mask = tokenize_queries(tok, texts + [""] * pad, max_length)
        scores, _, state = fn(model, ids, mask, tables)
        scores = scores.cpu().numpy()
        state = state.cpu().numpy()
        groups = np.where(state <= -2, -2 - state, -1)
        for bi in range(len(texts)):
            qid = queries.ids[s + bi]
            docs, doc_scores = expand_groups_to_docids(
                trie, groups[bi], scores[bi], topk)
            run[str(qid)] = {str(docids[d]): float(v)
                             for d, v in zip(docs, doc_scores)}
    with open(ws.path(run_name), "w") as f:
        json.dump(run, f)
    return run


def stage_evaluate(ws: Workspace, run, qrel,
                   metrics: Sequence[str] = ("mrr_10", "recall_10",
                                             "recall_100"),
                   perf_name: str = "perf.json") -> Dict[str, float]:
    out = {m: evaluate_run(run, qrel, m) for m in metrics}
    with open(ws.path(perf_name), "w") as f:
        json.dump(out, f, indent=2)
    ws.log(f"metrics: {out}")
    return out
