"""CLI entry points of the port: evaluate / retrieve / retrieve-merge /
serve / train.

Port of ripor_tpu/cli/main.py's subcommands of the retrieval path and of
``train``, with the same flags and defaults, and one more on ``retrieve``,
``serve`` and ``train``: ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path, and without CUDA the default raises). Retrieval runs
the model in bfloat16, its params rounded to bf16 as
ServeConfig.param_dtype does; training runs in float32. The other
subcommands of the JAX CLI wait for their slices (ROADMAP.md Queue 1).

Usage:
  python -m ripor_tpu_torch.cli.main retrieve --workspace ws --queries qdir \
      --beam 100 --topk 100                            # -> ws/run.json
  python -m ripor_tpu_torch.cli.main evaluate --qrel qrel.json \
      --run ws/run.json --metric mrr_10
  python -m ripor_tpu_torch.cli.main serve --workspace ws  # POST /retrieve
  python -m ripor_tpu_torch.cli.main train --config cfg.json
      # -> ws/checkpoints/<phase_name>/params.pt (pipeline/e2e.py's keys)
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


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
    from ripor_tpu_torch.decode.beam import resolve_device
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
    if args.mode == "dense":
        raise NotImplementedError(
            "serve --mode dense is not ported to ripor_tpu_torch yet (a "
            "later slice of the port: ROADMAP.md Queue 1 item 7)")
    from ripor_tpu_torch.data.datasets import load_docid_to_smtid
    from ripor_tpu_torch.pipeline.recipe import (load_tokenizer,
                                                 stage_build_trie)
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig, serve_http

    ws, cfg, params = _load_workspace_model(args.workspace, args.phase)
    tok = load_tokenizer(ws.path("tokenizer.json"))
    scfg = ServeConfig(num_beams=args.beam, topk=args.topk,
                       batch_sizes=tuple(args.batch_sizes),
                       kv_cache_quant=args.kv_quant or None,
                       ffn_int8=args.ffn_int8 or None,
                       ckpt_dir=str(ws.path(f"checkpoints/{args.phase}")),
                       max_delay_ms=args.max_delay_ms)
    print(f"warming shapes {scfg.batch_sizes} ...")
    docids, codes = load_docid_to_smtid(ws.path("docid_to_smtid.json"))
    trie = stage_build_trie(ws, codes, cfg.K)
    engine = RetrievalEngine(cfg, params, tok, trie, docids, scfg,
                             device=args.device)
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
                    help="cuda (default) or cpu (the plain PyTorch path)")
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
                    help="dense mode: approx_max_k top-k")
    ps.add_argument("--corpus-quant", default="", choices=["", "int8"],
                    help="dense mode: int8 device corpus (2x doc capacity)")
    ps.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
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
                    help="cuda (default) or cpu (the plain PyTorch path)")
    pt.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
