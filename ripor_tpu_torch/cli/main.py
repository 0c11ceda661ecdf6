"""CLI entry points of the port: evaluate / retrieve / retrieve-merge /
serve / train / e2e / index / merge-embs / aq-index / hnsw-index /
dense-retrieve / rerank / rerank-task / rerank-task-merge / datagen /
pipeline / full-recipe.

Port of ripor_tpu/cli/main.py's subcommands, with the same flags and
defaults, and one more on each subcommand that runs on a device
(``retrieve``, ``serve``, ``train``, ``e2e``, ``index``, ``aq-index``,
``dense-retrieve``, ``rerank``, ``rerank-task``, ``datagen``,
``full-recipe``, and ``pipeline``, which hands it to its stages):
``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path, and
without CUDA the default raises). Retrieval and encoding run the model in
bfloat16, its params rounded to bf16 as ServeConfig.param_dtype does;
``datagen``'s beam search runs in bfloat16 with float32 norm scales, as
the JAX flywheel; training and the BertCrossEncoder teacher run in
float32.

Usage:
  python -m ripor_tpu_torch.cli.main retrieve --workspace ws --queries qdir \
      --beam 100 --topk 100                            # -> ws/run.json
  python -m ripor_tpu_torch.cli.main evaluate --qrel qrel.json \
      --run ws/run.json --metric mrr_10
  python -m ripor_tpu_torch.cli.main serve --workspace ws  # POST /retrieve
  python -m ripor_tpu_torch.cli.main train --config cfg.json
      # -> ws/checkpoints/<phase_name>/params.pt (pipeline/e2e.py's keys)
  python -m ripor_tpu_torch.cli.main index --workspace ws --docs ddir
      # -> ws/embs/ shards; then merge-embs --emb-dir ws/embs --mmap-dir m
  python -m ripor_tpu_torch.cli.main aq-index --mmap-dir m --out-dir out
      # -> out/docid_to_smtid.json, out/codebooks.npz.npy
  python -m ripor_tpu_torch.cli.main dense-retrieve --workspace ws \
      --queries qdir --mmap-dir m [--device-corpus [--corpus-quant int8]]
  python -m ripor_tpu_torch.cli.main rerank --run ws/run.json \
      --queries qdir --docs ddir --tokenizer ws/tokenizer.json \
      --ce-checkpoint ws/checkpoints/bert_bce --ce-vocab-size V
      # -> teacher_trainset.jsonl ({"qid", "docids", "scores"} lines)
  python -m ripor_tpu_torch.cli.main rerank-task \
      --task rerank_for_create_trainset --out-dir out --tokenizer t.json \
      --queries qdir --docs ddir --ce-checkpoint ck --run run.json \
      --rank r --nranks R        # -> out/rerank_<r>.json, then
  python -m ripor_tpu_torch.cli.main rerank-task-merge \
      --task rerank_for_create_trainset --out-dir out --nranks R
  python -m ripor_tpu_torch.cli.main datagen --workspace ws --queries qdir \
      --teacher-trainset t.jsonl [--teacher bert --teacher-ckpt ck \
      --docs ddir]      # -> ws/lng_knp_qid_smtids_scores_{4,8,16,32}.train.json
  python -m ripor_tpu_torch.cli.main pipeline --config spec.json \
      [--from STAGE]    # stages of this CLI, resumed from the manifest
  python -m ripor_tpu_torch.cli.main full-recipe --workspace ws \
      --docs ddir --queries qdir --qrel qrel.json [--config kw.json]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ripor_tpu_torch.decode.beam import resolve_device


def cmd_evaluate(args):
    from ripor_tpu_torch.evaluation import load_and_evaluate
    out = {}
    for metric in args.metric:
        out.update(load_and_evaluate(args.qrel, args.run, metric))
    print(json.dumps(out, indent=2))


def _load_workspace_model(ws_dir: str, phase: str = "final"):
    """-> (workspace, config, state_dict of CPU tensors) of
    ``checkpoints/<phase>`` (params.pt, or the JAX package's Orbax tree)."""
    from ripor_tpu_torch.models import RiporConfig
    from ripor_tpu_torch.pipeline.recipe import Workspace
    from ripor_tpu_torch.train import load_params

    ws = Workspace(ws_dir)
    ckpt = ws.path(f"checkpoints/{phase}")
    cfg = RiporConfig.load(ckpt / "config.json")
    return ws, cfg, load_params(ckpt, cfg)


def _bf16_model(cfg, params, device):
    import torch

    from ripor_tpu_torch.models import RiporModel
    model = RiporModel(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict({k: v.to(torch.bfloat16) if v.is_floating_point()
                           else v for k, v in params.items()})
    return model


def cmd_retrieve(args):
    """Constrained-beam retrieval; with --nranks > 1, each rank decodes its
    strided query slice and writes run_{rank}.json for ``retrieve-merge``
    (reference DDP decode, evaluate.py:457-487). Prints where the run went
    and a ``retrieve_timing`` JSON line: seconds to load the model onto the
    device, to read the codes and build (or load) the trie, and to
    retrieve (stage_retrieve: the search's set-up, then every batch from
    its dispatch to run.json written)."""
    from ripor_tpu_torch.data.datasets import Collection, load_docid_to_smtid
    from ripor_tpu_torch.pipeline.recipe import (load_tokenizer,
                                                 stage_build_trie,
                                                 stage_retrieve)

    device = resolve_device(args.device)
    t0 = time.monotonic()
    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    model = _bf16_model(cfg, params, device)
    del params
    load_s = time.monotonic() - t0
    tok = load_tokenizer(ws.path("tokenizer.json"))
    t0 = time.monotonic()
    docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
    trie = stage_build_trie(ws, codes, cfg.K)
    trie_s = time.monotonic() - t0
    queries = Collection(args.queries)
    run_name = args.run_name
    if args.nranks > 1:
        queries = queries.shard(args.rank, args.nranks)
        stem, dot, ext = args.run_name.partition(".")
        run_name = f"{stem}_{args.rank}{dot}{ext}"
    t0 = time.monotonic()
    run = stage_retrieve(ws, cfg, model, tok, queries, trie, docids,
                         num_beams=args.beam, topk=args.topk,
                         run_name=run_name,
                         # the quant preflight needs the checkpoint dir to
                         # find a recorded ffn_int8 validation
                         ckpt_dir=str(ws.path(f"checkpoints/{args.phase}")))
    retrieve_s = time.monotonic() - t0
    print(f"wrote {ws.path(run_name)} ({len(run)} queries)")
    print("retrieve_timing", json.dumps({
        "device": str(device), "queries": len(run), "load_s": load_s,
        "trie_s": trie_s, "retrieve_s": retrieve_s,
        "queries_per_s": len(run) / retrieve_s}), flush=True)


def cmd_retrieve_merge(args):
    """Merge per-rank run_{rank}.json shards -> run.json (reference
    t5seq_aq_retrieve_docids_2, evaluate.py:489-526: qid-disjoint union;
    same-qid shards merge their doc dicts)."""
    from ripor_tpu_torch.pipeline.recipe import Workspace

    ws = Workspace(args.workspace)
    stem, dot, ext = args.run_name.partition(".")
    merged = {}
    found = []
    for rank in range(args.nranks):
        p = ws.path(f"{stem}_{rank}{dot}{ext}")
        if not p.exists():
            raise SystemExit(f"missing shard {p} (expected {args.nranks})")
        found.append(p)
        with open(p) as f:
            sub = json.load(f)
        for qid, rankdata in sub.items():
            if qid in merged:
                merged[qid].update(rankdata)
            else:
                merged[qid] = rankdata
    out = ws.path(args.run_name)
    with open(out, "w") as f:
        json.dump(merged, f)
    if not args.keep_shards:
        for p in found:
            p.unlink()
    print(f"wrote {out} ({len(merged)} queries from {args.nranks} shards)")


def cmd_serve(args):
    """Online retrieval service over a workspace: microbatching engine +
    HTTP endpoint (serve/; the reference has no serving path — its
    offline analogue is evaluate.py:457-526)."""
    from ripor_tpu_torch.data.datasets import load_docid_to_smtid
    from ripor_tpu_torch.pipeline.recipe import (load_tokenizer,
                                                 stage_build_trie)
    from ripor_tpu_torch.serve import (DenseEngine, RetrievalEngine,
                                       ServeConfig, serve_http)

    device = resolve_device(args.device)

    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    tok = load_tokenizer(ws.path("tokenizer.json"))
    scfg = ServeConfig(num_beams=args.beam, topk=args.topk,
                       batch_sizes=tuple(args.batch_sizes),
                       kv_cache_quant=args.kv_quant or None,
                       ffn_int8=args.ffn_int8 or None,
                       ckpt_dir=str(ws.path(f"checkpoints/{args.phase}")),
                       max_delay_ms=args.max_delay_ms)
    print(f"warming shapes {scfg.batch_sizes} ...")
    if args.mode == "dense":
        corpus, docids = _dense_corpus(args.mmap_dir, args.corpus_quant,
                                       device)
        engine = DenseEngine(cfg, params, tok, corpus, docids, scfg,
                             approx=args.approx, device=device)
    else:
        docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
        trie = stage_build_trie(ws, codes, cfg.K)
        engine = RetrievalEngine(cfg, params, tok, trie, docids, scfg,
                                 device=device)
    print(f"serving on http://{args.host}:{args.port} "
          f"(POST /retrieve, GET /stats)")
    serve_http(engine, host=args.host, port=args.port)


def cmd_train(args):
    """One training phase from a JSON config (pipeline/e2e.py::
    run_train_from_config); prints a ``train_timing`` JSON line with the
    wall seconds of the whole job."""
    from ripor_tpu_torch.pipeline.e2e import run_train_from_config
    cfg = json.loads(Path(args.config).read_text())
    t0 = time.monotonic()
    run_train_from_config(cfg, device=args.device)
    print("train_timing", json.dumps({
        "device": args.device, "loss_type": cfg["loss_type"],
        "seconds": time.monotonic() - t0}), flush=True)


def cmd_e2e(args):
    """Minimum end-to-end slice (SURVEY.md §7.2 / BASELINE config #1):
    tokenizer -> encode -> RQ docids -> seq2seq train -> trie ->
    constrained retrieve -> metrics (pipeline/e2e.py::run_e2e)."""
    from ripor_tpu_torch.pipeline.e2e import run_e2e
    cfg_overrides = {}
    if args.config:
        cfg_overrides = json.loads(Path(args.config).read_text())
    metrics = run_e2e(workspace=args.workspace, docs_dir=args.docs,
                      queries_dir=args.queries, qrel_path=args.qrel,
                      s2s_examples_path=args.s2s_examples,
                      device=args.device, **cfg_overrides)
    print(json.dumps(metrics, indent=2))


def cmd_index(args):
    """Encode the corpus into chunked embedding shards (reference
    evaluate.py task=mmap -> DenseIndexing.store_embs; one host shard per
    --rank of --nranks)."""
    from ripor_tpu_torch.data.datasets import Collection
    from ripor_tpu_torch.data.emb_store import (ShardWriter,
                                                host_shard_slice, write_plan)
    from ripor_tpu_torch.pipeline.recipe import encode_texts, load_tokenizer

    device = resolve_device(args.device)
    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    model = _bf16_model(cfg, params, device)
    del params
    tok = load_tokenizer(ws.path("tokenizer.json"))
    docs = Collection(args.docs)
    sl = host_shard_slice(len(docs), args.rank, args.nranks)
    writer = ShardWriter(ws.path("embs"), rank=args.rank,
                         chunk_size=args.chunk_size)
    ids_all = docs.ids[sl]
    for s in range(0, len(ids_all), args.batch_size):
        chunk_ids = ids_all[s:s + args.batch_size]
        writer.add(encode_texts(model, tok, [docs[d] for d in chunk_ids],
                                args.max_length, args.batch_size), chunk_ids)
    writer.finalize()
    if args.rank == args.nranks - 1:
        write_plan(ws.path("embs"), args.nranks)
    print(f"rank {args.rank}: wrote {writer.chunks_written} chunks")


def cmd_merge_embs(args):
    """Merge embedding shards -> doc_embeds.mmap + text_ids.tsv (reference
    evaluate.py task=mmap_2 -> aggregate_embs_to_mmap)."""
    from ripor_tpu_torch.data.emb_store import merge_to_mmap, write_plan
    if not (Path(args.emb_dir) / "plan.json").exists():
        write_plan(args.emb_dir, args.nranks)
    path, n = merge_to_mmap(args.emb_dir, args.mmap_dir)
    print(f"wrote {path} ({n} rows)")


def cmd_aq_index(args):
    """Train the RQ codebooks over the corpus mmap and emit
    docid_to_smtid.json + codebooks (reference evaluate.py task=aq_index ->
    AddictvieQuantizeIndexer.index + create_customized_smtid_file.py). The
    codebooks go to ``codebooks.npz`` through np.save, which names the
    file ``codebooks.npz.npy``, as the JAX CLI's."""
    from ripor_tpu_torch.data.datasets import save_docid_to_smtid
    from ripor_tpu_torch.data.emb_store import open_mmap
    from ripor_tpu_torch.quantize import rq_encode, train_rq

    device = resolve_device(args.device)
    embs, docids = open_mmap(args.mmap_dir, d=args.dim)
    x = embs[:args.max_train] if args.max_train else embs
    # stream k-means for corpora larger than one device buffer (8.8M x 768
    # fp32 is ~27 GB); the in-memory route is for slices up to 1M rows
    batch = args.kmeans_batch
    if batch == 0 and x.shape[0] > 1_000_000:
        batch = 1_000_000
    books = train_rq(x, M=args.M, K=args.K, kmeans_iters=args.kmeans_iters,
                     batch=batch, device=device)
    codes = rq_encode(books, embs, beam=args.encode_beam, device=device)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    books.save(out / "codebooks.npz")
    save_docid_to_smtid(out / "docid_to_smtid.json", docids, codes)
    uniq = len(np.unique(codes, axis=0))
    print(f"wrote {out}/docid_to_smtid.json: {len(docids)} docs, "
          f"{uniq} unique smtids ({uniq/len(docids):.1%})")


def cmd_hnsw_index(args):
    """Build the HNSW ANN graph over the corpus mmap (reference
    HNSWIndexer.index, tasks/evaluator.py:40-65); host code."""
    from ripor_tpu_torch.data.emb_store import open_mmap
    from ripor_tpu_torch.evaluation.hnsw import HnswIndex

    embs, docids = open_mmap(args.mmap_dir, d=args.dim)
    index = HnswIndex.build(np.asarray(embs), num_links=args.num_links,
                            ef_construct=args.ef_construct, docids=docids)
    index.save(args.index_dir)
    print(f"wrote {args.index_dir}/model.index "
          f"({index.size} vecs, native={index.is_native})")


def _dense_corpus(mmap_dir, corpus_quant, device, dim=None):
    """The corpus mmap uploaded to ``device`` as bf16 rows, or as an
    Int8Corpus with ``corpus_quant`` "int8"; and its docids."""
    import torch

    from ripor_tpu_torch.data.emb_store import open_mmap
    from ripor_tpu_torch.evaluation.retriever import device_corpus

    embs, docids = open_mmap(mmap_dir, d=dim)
    corpus = device_corpus(np.asarray(embs),
                           dtype=torch.int8 if corpus_quant == "int8"
                           else torch.bfloat16, device=device)
    return corpus, docids


def cmd_dense_retrieve(args):
    """Dense retrieval over the corpus: flat (exact top-k; reference
    task=retrieve) — the corpus streamed from the mmap in blocks, or held
    on the device with --device-corpus (bf16, or int8 rows with
    --corpus-quant int8) — or --ann hnsw (reference old HNSW path)."""
    from ripor_tpu_torch.data.datasets import Collection
    from ripor_tpu_torch.data.emb_store import open_mmap
    from ripor_tpu_torch.evaluation.retriever import (dense_topk,
                                                      retrieve_to_run)
    from ripor_tpu_torch.pipeline.recipe import encode_texts, load_tokenizer

    device = resolve_device(args.device)
    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    model = _bf16_model(cfg, params, device)
    del params
    tok = load_tokenizer(ws.path("tokenizer.json"))
    queries = Collection(args.queries)
    texts = [queries[q] for q in queries.ids]
    q_embs = encode_texts(model, tok, texts, args.max_length, len(texts),
                          queries=True)
    if args.ann == "hnsw":
        from ripor_tpu_torch.evaluation.hnsw import HnswIndex
        index = HnswIndex.load(args.index_dir)
        run = index.retrieve_to_run(queries.ids, q_embs, args.topk,
                                    ef_search=args.ef_search)
    else:
        if args.device_corpus:
            corpus, docids = _dense_corpus(args.mmap_dir, args.corpus_quant,
                                           device, args.dim)
            scores, idx = dense_topk(q_embs, corpus, args.topk,
                                     approx=args.approx)
        else:
            embs, docids = open_mmap(args.mmap_dir, d=args.dim)
            scores, idx = dense_topk(q_embs, np.asarray(embs), args.topk,
                                     device=device)
        run = retrieve_to_run(queries.ids, docids, scores, idx)
    with open(args.out, "w") as f:
        json.dump(run, f)
    print(f"wrote {args.out} ({len(run)} queries)")


def cmd_rerank(args):
    """Cross-encoder teacher scoring of a run file -> teacher trainset JSONL
    (reference rerank.py task=rerank_for_create_trainset{,_2})."""
    from ripor_tpu_torch.data.datasets import Collection
    from ripor_tpu_torch.evaluation.reranker import (load_bert_teacher,
                                                     rerank_pairs)
    from ripor_tpu_torch.pipeline.recipe import load_tokenizer

    tok = load_tokenizer(args.tokenizer)
    queries = Collection(args.queries)
    docs = Collection(args.docs)
    with open(args.run) as f:
        run = json.load(f)
    # load_bert_teacher reads bert_geometry.json next to the checkpoint and
    # derives token_type_ids from the [SEP] position (the training
    # convention)
    score_fn = load_bert_teacher(args.ce_checkpoint, args.ce_vocab_size,
                                 device=resolve_device(args.device))

    pairs = [(q, d) for q, dd in run.items() for d in list(dd)[:args.topk]]
    scored = rerank_pairs(score_fn, tok, queries, docs, pairs,
                          batch_size=args.batch_size,
                          max_length=args.max_length)
    with open(args.out, "w") as f:
        for qid, doc_scores in scored.items():
            ranked = sorted(doc_scores.items(), key=lambda kv: -kv[1])
            f.write(json.dumps({
                "qid": qid,
                "docids": [d for d, _ in ranked],
                "scores": [s for _, s in ranked]}) + "\n")
    print(f"wrote {args.out} ({len(scored)} queries)")


def _d2s_map(path):
    """docid_to_smtid.json -> {docid: code list} (sentinel already stripped
    by load_docid_to_smtid)."""
    from ripor_tpu_torch.data.datasets import load_docid_to_smtid
    docids, codes = load_docid_to_smtid(path)
    return dict(zip(docids, [list(map(int, c)) for c in codes]))


def cmd_rerank_task(args):
    """One sharded scoring pass of a reference rerank.py task (writes the
    per-rank JSON shard; run ``rerank-task-merge`` after all ranks finish).
    Task names match the reference's t5_pretrainer/rerank.py:655-691. The
    BertCrossEncoder teacher is built at the tokenizer's vocabulary size."""
    from ripor_tpu_torch.data.datasets import Collection, load_qrel
    from ripor_tpu_torch.evaluation import rerank_tasks as rt
    from ripor_tpu_torch.evaluation.reranker import load_bert_teacher
    from ripor_tpu_torch.pipeline.recipe import load_tokenizer

    device = resolve_device(args.device)
    tok = load_tokenizer(args.tokenizer)
    queries = Collection(args.queries) if args.queries else None
    docs = Collection(args.docs) if args.docs else None
    kw = dict(rank=args.rank, nranks=args.nranks,
              batch_size=args.batch_size, max_length=args.max_length)

    def teacher():
        return load_bert_teacher(args.ce_checkpoint, tok.vocab_size,
                                 device=device)

    t = args.task
    if t == "rerank_for_create_trainset":
        with open(args.run) as f:
            run = json.load(f)
        out = rt.rerank_for_create_trainset(teacher(), tok, queries, docs,
                                            run, args.out_dir, **kw)
    elif t == "assign_scores_for_pseudo_queries":
        with open(args.input_json) as f:
            docid_pseudo_qids = json.load(f)
        out = rt.assign_scores_for_pseudo_queries(
            teacher(), tok, queries, docs, docid_pseudo_qids,
            args.out_dir, **kw)
    elif t == "query_to_docid_rerank_for_qid_smtids":
        _, cfg, params = _load_workspace_model(args.workspace, args.phase)
        with open(args.input_json) as f:
            qid_docids = json.load(f)
        out = rt.query_to_docid_rerank_for_qid_smtids(
            cfg, params, tok, queries, qid_docids,
            _d2s_map(args.docid_to_smtid), args.out_dir, device=device,
            **kw)
    elif t == "teacher_rerank_for_qid_smtids":
        with open(args.input_json) as f:
            qid_smtid_rank = json.load(f)
        out = rt.teacher_rerank_for_qid_smtids(
            teacher(), tok, queries, docs, qid_smtid_rank,
            _d2s_map(args.docid_to_smtid), args.out_dir, **kw)
    elif t == "cross_encoder_rerank_for_same_prefix_docid":
        out = rt.cross_encoder_rerank_for_same_prefix_docid(
            teacher(), tok, queries, docs, _d2s_map(args.docid_to_smtid),
            load_qrel(args.qrel), args.out_dir,
            neg_sample=args.neg_sample, **kw)
    elif t == "cross_encoder_rerank_for_same_reldocid_hard_docids":
        with open(args.input_json) as f:
            pools = json.load(f)
        out = rt.cross_encoder_rerank_for_same_reldocid_hard_docids(
            teacher(), tok, queries, docs, pools, args.out_dir, **kw)
    elif t == "cross_encoder_rerank_for_qid_smtid_docids":
        out = rt.cross_encoder_rerank_for_qid_smtid_docids(
            teacher(), tok, queries, docs, args.input_json, **kw)
    else:
        raise SystemExit(f"unknown task {t}")
    print(f"wrote {out}")


def cmd_rerank_task_merge(args):
    """Merge a task's per-rank shards into its final artifact (the
    reference's *_2 tasks, rerank.py:67-654)."""
    from ripor_tpu_torch.data.datasets import load_qrel
    from ripor_tpu_torch.evaluation import rerank_tasks as rt

    t = args.task
    nr = args.nranks  # None -> merge whatever shards exist (legacy)
    if t == "rerank_for_create_trainset":
        out = rt.rerank_for_create_trainset_merge(args.out_dir,
                                                  topk=args.topk, nranks=nr)
    elif t == "rerank_for_evaluate":
        out = rt.rerank_for_evaluate_merge(args.out_dir, nranks=nr)
    elif t == "assign_scores_for_pseudo_queries":
        out = rt.assign_scores_for_pseudo_queries_merge(args.out_dir,
                                                        nranks=nr)
    elif t == "query_to_docid_rerank_for_qid_smtids":
        qrel = load_qrel(args.qrel) if args.qrel else None
        out, metrics = rt.query_to_docid_rerank_for_qid_smtids_merge(
            args.out_dir, _d2s_map(args.docid_to_smtid), qrel, nranks=nr)
        if metrics:
            print(json.dumps(metrics, indent=2))
    elif t == "teacher_rerank_for_qid_smtids":
        out = rt.teacher_rerank_for_qid_smtids_merge(args.out_dir, nranks=nr)
    elif t == "cross_encoder_rerank_for_same_prefix_docid":
        out, _ = rt.cross_encoder_rerank_for_same_prefix_docid_merge(
            args.out_dir, nranks=nr)
    elif t == "cross_encoder_rerank_for_same_reldocid_hard_docids":
        out = rt.cross_encoder_rerank_for_same_reldocid_hard_docids_merge(
            args.out_dir, nranks=nr)
    elif t == "cross_encoder_rerank_for_qid_smtid_docids":
        out = rt.cross_encoder_rerank_for_qid_smtid_docids_merge(
            args.out_dir, nranks=nr)
    else:
        raise SystemExit(f"unknown task {t}")
    print(f"wrote {out}")


def cmd_full_recipe(args):
    """Phases 1-3 end-to-end (reference full_scripts/full_lng_knp_train_
    pipline.sh chain; pipeline/full_recipe.py) with per-phase metrics
    printed. ``--config``: a JSON object of run_full_recipe keywords."""
    from ripor_tpu_torch.pipeline.full_recipe import run_full_recipe
    overrides = json.loads(Path(args.config).read_text()) if args.config else {}
    metrics = run_full_recipe(workspace=args.workspace, docs_dir=args.docs,
                              queries_dir=args.queries, qrel_path=args.qrel,
                              device=args.device, **overrides)
    print(json.dumps(metrics, indent=2))


def cmd_pipeline(args):
    """Declarative multi-stage pipeline with manifest resume (replaces the
    reference's chained full_scripts/*.sh; pipeline/runner.py). Each stage
    is an argv of this CLI; ``--device`` is added to the stages whose
    subcommand takes one and whose argv names none."""
    from ripor_tpu_torch.pipeline.runner import run_pipeline

    def cli(argv):
        argv = list(argv)
        if (argv and argv[0] in args.device_commands
                and "--device" not in argv):
            argv += ["--device", args.device]
        main(argv)

    spec = json.loads(Path(args.config).read_text())
    ran = run_pipeline(spec, cli_main=cli, from_stage=args.from_stage)
    print(f"pipeline complete ({len(ran)} stages ran)")


def cmd_datagen(args):
    """Phase-3 flywheel: D^B beam prefix candidates + D^R grouping, teacher
    rescoring of EVERY (query, prefix, docid) triple, then decay merge +
    lng_knp score attachment (replaces the reference's
    t5seq_aq_get_qid_to_smtid_rankdata + cross_encoder_rerank_for_
    qid_smtid_docids + aq_preprocess merge scripts; rerank.py:587-654).

    Teacher: ``--teacher bert --teacher-ckpt DIR`` uses a BertCrossEncoder
    checkpoint built at the tokenizer's vocabulary (the reference's MiniLM
    role); the default ``--teacher self`` scores pairs with the phase
    model's own rerank_score (self-distillation). Either way every doc
    carries a true teacher score — no 0.0 defaults. Prints a
    ``datagen_timing`` JSON line per prefix length: seconds and the pairs
    the teacher scored."""
    import torch

    from ripor_tpu_torch.data.datasets import Collection, load_docid_to_smtid
    from ripor_tpu_torch.evaluation.reranker import (
        load_bert_teacher, rerank_pairs, self_rerank_pair_scores)
    from ripor_tpu_torch.pipeline.flywheel import (datagen_round, read_jsonl,
                                                   search_model, write_jsonl)
    from ripor_tpu_torch.pipeline.recipe import load_tokenizer

    device = resolve_device(args.device)
    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    tok = load_tokenizer(ws.path("tokenizer.json"))
    docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
    queries = Collection(args.queries)
    teacher_examples = read_jsonl(args.teacher_trainset)
    qid_to_docids = {str(ex["qid"]): [str(d) for d in ex["docids"]]
                     for ex in teacher_examples}
    d2c = dict(zip(docids, codes))
    searcher = search_model(cfg, params, torch.bfloat16, device)

    if args.teacher == "bert":
        if not args.teacher_ckpt:
            raise SystemExit("--teacher bert requires --teacher-ckpt")
        if not args.docs:
            raise SystemExit("--teacher bert requires --docs (the teacher "
                             "scores raw (query, document) text pairs)")
        docs_coll = Collection(args.docs)
        score_fn = load_bert_teacher(args.teacher_ckpt, tok.vocab_size,
                                     device=device)

        def score_pairs(pairs):
            return rerank_pairs(score_fn, tok, queries, docs_coll, pairs,
                                batch_size=args.batch_size * 8,
                                max_length=args.max_length)
    else:
        def score_pairs(pairs):
            return self_rerank_pair_scores(
                cfg, params, tok, queries, d2c, pairs,
                batch_size=args.batch_size * 8, max_length=args.max_length,
                device=device)

    n_pairs = []

    def counted(pairs):
        n_pairs.append(len(pairs))
        return score_pairs(pairs)

    for plen in args.prefix_lengths:
        t0 = time.monotonic()
        # as in the JAX CLI, --max-length reaches the teacher's pairs and
        # not the beam search, whose queries encode at 64 positions
        merged = datagen_round(cfg, searcher, tok, queries, qid_to_docids,
                               codes, docids, counted, prefix_len=plen,
                               num_beams=args.beam,
                               batch_size=args.batch_size, decay=args.decay,
                               device=device)
        out_path = ws.path(f"lng_knp_qid_smtids_scores_{plen}.train.json")
        write_jsonl(out_path, merged)
        print(f"wrote {out_path} ({len(merged)} examples)")
        print("datagen_timing", json.dumps({
            "device": str(device), "prefix_len": plen,
            "seconds": time.monotonic() - t0,
            "pairs_scored": n_pairs[-1]}), flush=True)


RERANK_TASKS = [
    "rerank_for_create_trainset",
    "assign_scores_for_pseudo_queries",
    "query_to_docid_rerank_for_qid_smtids",
    "teacher_rerank_for_qid_smtids",
    "cross_encoder_rerank_for_same_prefix_docid",
    "cross_encoder_rerank_for_same_reldocid_hard_docids",
    "cross_encoder_rerank_for_qid_smtid_docids",
]

DEVICE_HELP = "cuda (default) or cpu (the plain PyTorch path)"


def main(argv=None):
    p = argparse.ArgumentParser(prog="ripor_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("evaluate", help="trec metrics over a run file")
    pe.add_argument("--qrel", required=True)
    pe.add_argument("--run", required=True)
    pe.add_argument("--metric", nargs="+", default=["mrr_10"])
    pe.set_defaults(fn=cmd_evaluate)

    pr = sub.add_parser("retrieve", help="constrained-beam retrieval")
    pr.add_argument("--workspace", required=True)
    pr.add_argument("--queries", required=True)
    pr.add_argument("--phase", default="final")
    pr.add_argument("--beam", type=int, default=100)
    pr.add_argument("--topk", type=int, default=100)
    pr.add_argument("--run-name", default="run.json")
    pr.add_argument("--rank", type=int, default=0)
    pr.add_argument("--nranks", type=int, default=1)
    pr.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    pr.set_defaults(fn=cmd_retrieve)

    ps = sub.add_parser("serve", help="online retrieval HTTP service")
    ps.add_argument("--workspace", required=True)
    ps.add_argument("--phase", default="final")
    ps.add_argument("--beam", type=int, default=100)
    ps.add_argument("--topk", type=int, default=100)
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8600)
    ps.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 4, 8])
    ps.add_argument("--kv-quant", default="",
                    help="int8|int4 decode KV cache")
    ps.add_argument("--ffn-int8", action="store_true",
                    help="int8-weight FFN — preflighted against the "
                         "checkpoint's quant_validation.json (refuses when "
                         "unvalidated)")
    ps.add_argument("--max-delay-ms", type=float, default=5.0)
    ps.add_argument("--mode", choices=["beam", "dense"], default="beam")
    ps.add_argument("--mmap-dir", default=None,
                    help="dense mode: doc_embeds.mmap directory")
    ps.add_argument("--approx", action="store_true",
                    help="dense mode: accepted; the top-k is exact")
    ps.add_argument("--corpus-quant", default="", choices=["", "int8"],
                    help="dense mode: int8 device corpus (2x doc capacity)")
    ps.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    ps.set_defaults(fn=cmd_serve)

    prm = sub.add_parser("retrieve-merge",
                         help="merge per-rank run shards -> run.json")
    prm.add_argument("--workspace", required=True)
    prm.add_argument("--run-name", default="run.json")
    prm.add_argument("--nranks", type=int, required=True)
    prm.add_argument("--keep-shards", action="store_true")
    prm.set_defaults(fn=cmd_retrieve_merge)

    pt = sub.add_parser("train", help="train one phase from a JSON config")
    pt.add_argument("--config", required=True)
    pt.add_argument("--device", default="cuda",
                    help=DEVICE_HELP)
    pt.set_defaults(fn=cmd_train)

    p2 = sub.add_parser("e2e", help="end-to-end small pipeline")
    p2.add_argument("--workspace", required=True)
    p2.add_argument("--docs", required=True)
    p2.add_argument("--queries", required=True)
    p2.add_argument("--qrel", required=True)
    p2.add_argument("--s2s-examples", default=None)
    p2.add_argument("--config", default=None)
    p2.add_argument("--device", default="cuda", help=DEVICE_HELP)
    p2.set_defaults(fn=cmd_e2e)

    pi = sub.add_parser("index", help="encode corpus to embedding shards")
    pi.add_argument("--workspace", required=True)
    pi.add_argument("--docs", required=True)
    pi.add_argument("--phase", default="final")
    pi.add_argument("--rank", type=int, default=0)
    pi.add_argument("--nranks", type=int, default=1)
    pi.add_argument("--batch-size", type=int, default=256)
    pi.add_argument("--max-length", type=int, default=128)
    pi.add_argument("--chunk-size", type=int, default=500_000)
    pi.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pi.set_defaults(fn=cmd_index)

    pm = sub.add_parser("merge-embs", help="merge shards -> doc_embeds.mmap")
    pm.add_argument("--emb-dir", required=True)
    pm.add_argument("--mmap-dir", required=True)
    pm.add_argument("--nranks", type=int, default=1)
    pm.set_defaults(fn=cmd_merge_embs)

    pa = sub.add_parser("aq-index", help="train RQ codebooks + docid_to_smtid")
    pa.add_argument("--mmap-dir", required=True)
    pa.add_argument("--out-dir", required=True)
    pa.add_argument("--M", type=int, default=32)
    pa.add_argument("--K", type=int, default=256)
    pa.add_argument("--dim", type=int, default=None)
    pa.add_argument("--kmeans-iters", type=int, default=25)
    pa.add_argument("--encode-beam", type=int, default=4)
    pa.add_argument("--max-train", type=int, default=0,
                    help="cap k-means training rows (0 = all)")
    pa.add_argument("--kmeans-batch", type=int, default=0,
                    help="stream k-means in row blocks (0 = auto: stream "
                         "above 1M rows)")
    pa.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pa.set_defaults(fn=cmd_aq_index)

    ph = sub.add_parser("hnsw-index", help="build HNSW ANN graph from mmap")
    ph.add_argument("--mmap-dir", required=True)
    ph.add_argument("--index-dir", required=True)
    ph.add_argument("--dim", type=int, default=None)
    ph.add_argument("--num-links", type=int, default=32)
    ph.add_argument("--ef-construct", type=int, default=128)
    ph.set_defaults(fn=cmd_hnsw_index)

    pdr = sub.add_parser("dense-retrieve", help="dense retrieval (flat|hnsw)")
    pdr.add_argument("--workspace", required=True)
    pdr.add_argument("--queries", required=True)
    pdr.add_argument("--phase", default="final")
    pdr.add_argument("--ann", choices=["flat", "hnsw"], default="flat")
    pdr.add_argument("--mmap-dir", default=None)
    pdr.add_argument("--index-dir", default=None)
    pdr.add_argument("--dim", type=int, default=None)
    pdr.add_argument("--topk", type=int, default=100)
    pdr.add_argument("--ef-search", type=int, default=128)
    pdr.add_argument("--max-length", type=int, default=64)
    pdr.add_argument("--out", default="run.json")
    pdr.add_argument("--device-corpus", action="store_true",
                     help="hold the corpus on the device as bf16 (8.8M x "
                          "768 in 13.6 GB) and scan it there")
    pdr.add_argument("--approx", action="store_true",
                     help="accepted for the JAX CLI's sake; the top-k is "
                          "exact (device-corpus path only)")
    pdr.add_argument("--corpus-quant", default="", choices=["", "int8"],
                     help="int8 device corpus (1 byte/dim + per-row scale); "
                          "device-corpus only")
    pdr.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pdr.set_defaults(fn=cmd_dense_retrieve)

    prr = sub.add_parser("rerank", help="cross-encoder teacher scoring")
    prr.add_argument("--run", required=True)
    prr.add_argument("--queries", required=True)
    prr.add_argument("--docs", required=True)
    prr.add_argument("--tokenizer", required=True)
    prr.add_argument("--ce-checkpoint", required=True)
    prr.add_argument("--ce-vocab-size", type=int, default=32000)
    prr.add_argument("--topk", type=int, default=100)
    prr.add_argument("--batch-size", type=int, default=64)
    prr.add_argument("--max-length", type=int, default=256)
    prr.add_argument("--out", default="teacher_trainset.jsonl")
    prr.add_argument("--device", default="cuda", help=DEVICE_HELP)
    prr.set_defaults(fn=cmd_rerank)

    prt = sub.add_parser("rerank-task",
                         help="one reference rerank.py task (sharded pass)")
    prt.add_argument("--task", required=True, choices=RERANK_TASKS)
    prt.add_argument("--out-dir", required=True)
    prt.add_argument("--tokenizer", required=True)
    prt.add_argument("--queries")
    prt.add_argument("--docs")
    prt.add_argument("--ce-checkpoint")
    prt.add_argument("--run")
    prt.add_argument("--input-json",
                     help="task-specific input (qid_docids / pseudo qids / "
                          "qid_smtid_rank / hard pools / qid_smtid_docids)")
    prt.add_argument("--docid-to-smtid")
    prt.add_argument("--qrel")
    prt.add_argument("--workspace")
    prt.add_argument("--phase", default="final")
    prt.add_argument("--neg-sample", type=int, default=50)
    prt.add_argument("--rank", type=int, default=0)
    prt.add_argument("--nranks", type=int, default=1)
    prt.add_argument("--batch-size", type=int, default=64)
    prt.add_argument("--max-length", type=int, default=256)
    prt.add_argument("--device", default="cuda", help=DEVICE_HELP)
    prt.set_defaults(fn=cmd_rerank_task)

    prtm = sub.add_parser("rerank-task-merge",
                          help="merge a task's rank shards (the ref's *_2)")
    prtm.add_argument("--task", required=True,
                      choices=RERANK_TASKS + ["rerank_for_evaluate"])
    prtm.add_argument("--out-dir", required=True)
    prtm.add_argument("--nranks", type=int, default=None,
                      help="verify shards for ranks 0..nranks-1 all exist "
                           "before merging (omit to merge whatever is there)")
    prtm.add_argument("--topk", type=int, default=200)
    prtm.add_argument("--docid-to-smtid")
    prtm.add_argument("--qrel")
    prtm.set_defaults(fn=cmd_rerank_task_merge)

    pf = sub.add_parser("full-recipe", help="3-phase RIPOR recipe end-to-end")
    pf.add_argument("--workspace", required=True)
    pf.add_argument("--docs", required=True)
    pf.add_argument("--queries", required=True)
    pf.add_argument("--qrel", required=True)
    pf.add_argument("--config", default=None,
                    help="JSON overrides for run_full_recipe kwargs")
    pf.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pf.set_defaults(fn=cmd_full_recipe)

    pp = sub.add_parser("pipeline", help="multi-stage pipeline w/ resume")
    pp.add_argument("--config", required=True)
    pp.add_argument("--from", dest="from_stage", default=None,
                    help="force re-run from this stage")
    pp.add_argument("--device", default="cuda",
                    help=DEVICE_HELP + "; added to each stage that takes "
                         "--device and names none")
    pp.set_defaults(fn=cmd_pipeline)

    pd = sub.add_parser("datagen", help="phase-3 flywheel data generation")
    pd.add_argument("--workspace", required=True)
    pd.add_argument("--queries", required=True)
    pd.add_argument("--teacher-trainset", required=True,
                    help="JSONL {'qid','docids','scores'} from the teacher")
    pd.add_argument("--phase", default="final")
    pd.add_argument("--prefix-lengths", type=int, nargs="+",
                    default=[4, 8, 16, 32])
    pd.add_argument("--beam", type=int, default=100)
    pd.add_argument("--batch-size", type=int, default=4)
    pd.add_argument("--decay", type=int, default=2)
    pd.add_argument("--teacher", choices=["self", "bert"], default="self",
                    help="pair scorer: the phase model's own rerank_score "
                         "(self) or a BertCrossEncoder checkpoint (bert)")
    pd.add_argument("--teacher-ckpt", default=None,
                    help="BertCrossEncoder checkpoint dir (teacher=bert)")
    pd.add_argument("--docs", default=None,
                    help="doc collection dir (required for teacher=bert)")
    pd.add_argument("--max-length", type=int, default=64)
    pd.add_argument("--device", default="cuda", help=DEVICE_HELP)
    pd.set_defaults(fn=cmd_datagen)

    # the subcommands that take --device: ``pipeline`` hands its own to them
    pp.set_defaults(device_commands={
        name for name, sp in sub.choices.items()
        if "--device" in sp._option_string_actions})

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
