"""CLI entry points of the port: evaluate / retrieve / retrieve-merge /
serve / train / e2e / index / merge-embs / aq-index / hnsw-index /
dense-retrieve.

Port of ripor_tpu/cli/main.py's subcommands of the retrieval and dense
paths, the DocID build, ``train`` and ``e2e``, with the same flags and
defaults, and one more on each subcommand that runs on a device
(``retrieve``, ``serve``, ``train``, ``e2e``, ``index``, ``aq-index``,
``dense-retrieve``): ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path, and without CUDA the default raises). Retrieval and
encoding run the model in bfloat16, its params rounded to bf16 as
ServeConfig.param_dtype does; training runs in float32. The teacher,
baseline and pipeline subcommands of the JAX CLI (rerank*, full-recipe,
pipeline, datagen) wait for their slices (ROADMAP.md Queue 1).

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

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
