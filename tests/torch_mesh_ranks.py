"""Ranks of a CPU gloo world for the port's mesh tests
(tests/test_torch_mesh.py, tests/test_torch_sharded_decode.py,
tests/test_torch_mesh_serve.py, tests/test_torch_mesh_train.py).

``start(job, inputs, workdir)`` launches WORLD processes, each running
``python tests/torch_mesh_ranks.py RANK WORLD WORKDIR JOB``: the rank
joins the world through ``core.mesh.distributed_init`` on a FileStore in
``workdir`` (no port, so test files may run side by side), builds the
data=2 x model=2 mesh on the CPU, runs ``JOBS[JOB](mesh, inputs)`` with one
thread (``inputs["workdir"]``: the world's shared directory) and writes
its result. ``collect`` waits for every rank under a
timeout, kills them all if one hangs, and fails with the failing rank's
log. This module imports no JAX: the ranks load only torch and the port.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
DATA, MODEL = 2, 2

# The sharded-decode cases: (name, mesh fn, seed, beams, keyword
# arguments), one for each test of tests/test_sharded_decode.py
# (ripor_small(M=4, K=8), float32, 8 queries of 9 tokens, one trie of 60
# docs; "ragged" takes the first 5 queries).
DECODE_CASES = [
    ("dp_exact", "dp", 0, 5, dict(use_pallas_gather=False)),
    ("dp_int8", "dp", 1, 5,
     dict(use_pallas_gather=False, deferred=True, kv_cache_int8=True,
          cache_segments=2)),
    ("tp_exact", "tp", 2, 5, dict(use_pallas_gather=False)),
    ("tp_int8", "tp", 3, 5,
     dict(use_pallas_gather=False, deferred=True, kv_cache_int8=True,
          cache_segments=2)),
    ("ragged", "dp", 4, 5, dict(use_pallas_gather=False)),
    ("dp_megarow", "dp", 5, 4,
     dict(use_pallas_gather=False, megarow=True, cache_segments=2)),
    ("tp_megarow_int4", "tp", 6, 5,
     dict(use_pallas_gather=False, megarow=True, kv_cache_quant="int4",
          cache_segments=2)),
    ("tp_megarow_exact", "tp", 7, 4,
     dict(use_pallas_gather=False, megarow=True, cache_segments=2)),
    ("tp_ffn_int8", "tp", 8, 5,
     dict(use_pallas_gather=False, megarow=True, cache_segments=2,
          ffn_int8=True)),
    # bf16 TP with an int4 cache: chip_smoke.py phase 12's path at a toy
    # size
    ("tp_bf16_int4", "tp", 9, 5,
     dict(dtype="bfloat16", megarow=True, kv_cache_quant="int4",
          cache_segments=2)),
]


def start(job: str, inputs, workdir: Path):
    """Launch the ranks; returns the handle ``collect`` takes."""
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(WORLD):
        log = open(workdir / f"rank{r}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__)), str(r), str(WORLD),
             str(workdir), job],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(REPO)),
            log))
    return workdir, procs


def collect(handle, timeout: float = 120.0):
    """Every rank's result, in rank order; fails (after killing every
    rank) if one exits non-zero or the world outlives ``timeout``."""
    workdir, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            tail = (workdir / f"rank{r}.log").read_text()[-3000:]
            raise AssertionError(f"rank {r} exited {p.returncode} (timeout "
                                 f"{timeout} s):\n{tail}")
    out = []
    for r in range(WORLD):
        with open(workdir / f"result{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- jobs (run inside a rank) ----

def _numpy(xs):
    return tuple(x.cpu().numpy() for x in xs)


def job_decode(mesh, inputs):
    """Every DECODE_CASES search on the mesh, plus the ragged batch's
    ValueError and padding."""
    import dataclasses

    import torch

    from ripor_tpu_torch.decode.beam import (make_sharded_beam_search_fn,
                                             make_tp_beam_search_fn,
                                             pad_batch_to_data_axis)
    from ripor_tpu_torch.models import RiporModel, ripor_small
    from ripor_tpu_torch.trie import (build_trie, succinct_tables,
                                      tables_to_torch)

    cfg = ripor_small(M=4, K=8)
    tables = tables_to_torch(succinct_tables(build_trie(inputs["docs"], 8)),
                             "cpu")
    out = {}
    for name, kind, _, beams, kw in DECODE_CASES:
        sd, ids, mask = inputs[name]
        kw = dict(kw, dtype=getattr(torch, kw.get("dtype", "float32")))
        model = RiporModel(cfg, dtype=kw["dtype"], device="cpu")
        model.load_state_dict(sd)
        make = (make_sharded_beam_search_fn if kind == "dp"
                else make_tp_beam_search_fn)
        fn = make(cfg, beams, mesh, device="cpu", **kw)
        if name == "ragged":
            try:
                fn(model, ids, mask, tables)
            except ValueError as e:
                out["ragged_error"] = str(e)
            pids, pmask, n = pad_batch_to_data_axis(ids, mask, mesh)
            out["ragged_pad"] = (pids, pmask, n)
            out[name] = _numpy(fn(model, pids, pmask, tables))
        else:
            out[name] = _numpy(fn(model, ids, mask, tables))
        if name == "tp_exact":
            # the rank's model is kept while the params are unchanged,
            # and built anew after an in-place change
            again = _numpy(fn(model, ids, mask, tables))
            model.decoder.layers[0].ffn.wo.weight.mul_(2.0)
            changed = _numpy(fn(model, ids, mask, tables))
            fresh = _numpy(make(cfg, beams, mesh, device="cpu", **kw)(
                model, ids, mask, tables))
            out["tp_cache"] = (again, changed, fresh)
    # the refusal of heads that do not divide the model axis
    odd = dataclasses.replace(cfg, t5=dataclasses.replace(cfg.t5,
                                                          num_heads=3))
    try:
        make_tp_beam_search_fn(odd, 5, mesh, dtype=torch.float32,
                               device="cpu")
    except ValueError as e:
        out["tp_heads_error"] = str(e)
    return out


def job_mesh(mesh, inputs):
    """The mesh's own surface, the engine and dense_topk on the mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ripor_tpu_torch.core import mesh as mesh_lib
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.evaluation.retriever import dense_topk, device_corpus
    from ripor_tpu_torch.parallel.sharding import (batch_sharding,
                                                   shard_batch,
                                                   shard_decode_params)
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import build_trie

    out = {}
    d, m = (mesh.get_local_rank(a) for a in ("data", "model"))
    out["coords"] = (dist.get_rank(), d, m)
    out["sizes"] = (mesh_lib.axis_size(mesh, "data"),
                    mesh_lib.axis_size(mesh, "model"))
    out["process"] = (mesh_lib.process_count(), mesh_lib.is_first_process())
    out["placements"] = [str(p) for p in (
        mesh_lib.shard(mesh, None, "model"), mesh_lib.replicated(mesh),
        mesh_lib.data_sharded(mesh, 2), batch_sharding(mesh))]
    # the model group's sum, in the tensor's dtype
    g = mesh.get_group("model")
    for dt in (torch.bfloat16, torch.float32):
        x = torch.full((3,), 1.0 + m * 2 ** -7, dtype=dt)
        y = mesh_lib.all_reduce_sum(x, g)
        out[f"sum_{dt}"] = (y.dtype, y.float().numpy())
    batch = {"ids": np.arange(8)[:, None] * np.ones((1, 3), np.int64),
             "rest": [torch.arange(8.0)]}
    out["batch"] = shard_batch(batch, mesh)
    try:
        shard_batch({"ids": np.zeros((5, 2))}, mesh)
    except ValueError as e:
        out["batch_error"] = str(e)
    out["decode_slice"] = {k: v.numpy() for k, v in shard_decode_params(
        inputs["state_dict"], mesh).items()}

    # the engine on the mesh (tests/test_serve.py:106-127)
    cfg, sd, doc_codes, queries, scfg_kw = inputs["engine"]
    docids = [f"d{i}" for i in range(len(doc_codes))]
    trie = build_trie(doc_codes, 8)
    eng = RetrievalEngine(cfg, sd, HashTokenizer(100), trie, docids,
                          ServeConfig(**scfg_kw), mesh=mesh, device="cpu")
    out["engine"] = eng.retrieve_batch(queries)
    try:
        out["submit"] = type(eng.submit(queries[0])).__name__
    except ValueError as e:
        out["submit_error"] = str(e)
    eng.stop()
    try:
        RetrievalEngine(cfg, sd, HashTokenizer(100), trie, docids,
                        ServeConfig(num_beams=5, batch_sizes=(3,)),
                        warm=False, mesh=mesh, device="cpu")
    except ValueError as e:
        out["rung_error"] = str(e)

    # dense_topk on the mesh (tests/test_eval.py:155-176, :262)
    q, docs, qb, db = inputs["dense"]
    out["dense_f32"] = dense_topk(q, docs, 6, mesh=mesh, device="cpu")
    out["dense_blocks"] = dense_topk(q, docs, 6, mesh=mesh, device="cpu",
                                     block_docs=8)
    dbf = device_corpus(db, torch.bfloat16, device="cpu")
    out["dense_bf16"] = dense_topk(qb, dbf, 5, mesh=mesh)
    # 63 rows do not divide the data axis: the single-device route
    out["dense_ragged"] = dense_topk(q, docs[:63], 6, mesh=mesh,
                                     device="cpu")
    try:
        dense_topk(q, device_corpus(docs, torch.int8, device="cpu"), 5,
                   mesh=mesh)
    except NotImplementedError as e:
        out["int8_error"] = str(e)
    return out


def _post(port, queries):
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/retrieve", json.dumps({"queries": queries}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def job_serve(mesh, inputs):
    """The mesh engine served through submit and HTTP (every rank calls
    start/stop; rank 0 alone submits), its queued futures at stop(), and
    a follower's exception at stop()."""
    import threading

    from ripor_tpu_torch.core.mesh import is_first_process
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.serve.http import serve_http
    from ripor_tpu_torch.trie import build_trie

    cfg, sd, doc_codes, queries, scfg_kw = inputs["engine"]
    first = is_first_process()
    docids = [f"d{i}" for i in range(len(doc_codes))]
    trie = build_trie(doc_codes, 8)
    eng = RetrievalEngine(cfg, sd, HashTokenizer(100), trie, docids,
                          ServeConfig(**scfg_kw), mesh=mesh, device="cpu")
    out = {"follows": eng.follows}
    out["retrieve"] = eng.retrieve_batch(queries[:3])
    out["retrieve_all"] = eng.retrieve_batch(queries)
    # a request queued before start fails at stop(); a follower refuses
    if first:
        orphan = eng.submit("orphaned query")
    else:
        try:
            eng.submit(queries[0])
        except ValueError as e:
            out["submit_error"] = str(e)
    eng.stop()
    if first:
        try:
            orphan.result(timeout=5)
        except RuntimeError as e:
            out["orphan_error"] = str(e)
    # submit and HTTP on rank 0, the followers run every batch
    server = serve_http(eng, port=0, block=False)
    out["server"] = server is not None
    if first:
        futures = [eng.submit(q) for q in queries]
        out["submit"] = [f.result(timeout=120) for f in futures]
        port = server.server_address[1]
        out["http_single"] = [_post(port, [q]) for q in queries[:3]]
        out["http_batch"] = _post(port, queries[:3])
        out["stats"] = eng.stats()
        server.shutdown()
        server.server_close()
    eng.stop()
    out["threads_after_stop"] = sorted(
        t.name for t in threading.enumerate() if t.name.startswith("ripor-"))
    # a follower's exception reaches its stop(): rank 1 fails after the
    # second batch it runs (its collectives done, so rank 0 is not held)
    if mesh.get_local_rank("data") == 0 and mesh.get_local_rank(
            "model") == 1:
        decode, seen = eng._decode, []

        def failing(texts):
            res = decode(texts)
            seen.append(texts)
            if len(seen) == 2:
                raise RuntimeError("injected follower fault")
            return res
        eng._decode = failing
    eng.start()
    if first:
        out["after_fault"] = [eng.submit(q).result(timeout=120)
                              for q in queries[:2]]
    try:
        eng.stop()
        out["stop_error"] = None
    except RuntimeError as e:
        out["stop_error"] = str(e)
    try:
        RetrievalEngine(cfg, sd, HashTokenizer(100), trie, docids,
                        ServeConfig(num_beams=5, batch_sizes=(3,)),
                        warm=False, mesh=mesh, device="cpu")
    except ValueError as e:
        out["rung_error"] = str(e)
    return out


def job_train(mesh, inputs):
    """Trainer(mesh=) replicated and ZeRO, at dropout 0 and 0.1, fed
    global batches, device_prefetch(sharding=) slices and grad_accum=2
    micro-batches; a ZeRO
    checkpoint resumed on the mesh; a one-process checkpoint resumed on
    the mesh; stage_train(mesh=); seq2seq training with per-rank
    embedding shards merged by rank 0 (tests/mp_worker.py's run); the
    ZeRO specs and shard_params' blocks."""
    import dataclasses
    import os
    import shutil

    import numpy as np
    import torch

    from ripor_tpu_torch.core.mesh import barrier, is_first_process
    from ripor_tpu_torch.data.emb_store import (ShardWriter,
                                                host_shard_slice,
                                                merge_to_mmap, open_mmap,
                                                write_plan)
    from ripor_tpu_torch.data.loader import device_prefetch
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.parallel import shard_params
    from ripor_tpu_torch.pipeline.recipe import Workspace, stage_train
    from ripor_tpu_torch.train import TrainConfig, Trainer

    cfg, sd, batches = inputs["cfg"], inputs["sd"], inputs["batches"]
    root = inputs["workdir"]
    tcfg = TrainConfig(**inputs["tcfg"])
    zcfg = dataclasses.replace(tcfg, shard_opt_state=True)

    def run(tc, bs, c=cfg, **kw):
        logs = []
        trainer = Trainer(RiporModel(c, device="cpu"), tc, sd, mesh=mesh,
                          log_fn=lambda m, s: logs.append(
                              {k: float(v) for k, v in m.items()
                               if k in ("loss", "rank", "grad_norm")}),
                          **kw)
        state, _ = trainer.run(bs, seed=0, log_every=1)
        return trainer, logs, {k: v.detach().numpy().copy()
                               for k, v in state.params.items()}

    def checksum(params):
        return float(sum(np.abs(v).sum(dtype=np.float64)
                         for v in params.values()))

    out = {}
    _, out["rep_logs"], out["rep"] = run(tcfg, batches)
    tz, out["zero_logs"], out["zero"] = run(zcfg, batches)
    out["zero_blocks"] = {k: tuple(v.shape)
                          for k, v in tz.state.opt_state["mu"].items()}
    out["zero_specs"] = tz._zero["mu"]
    moments = [t for m in ("mu", "nu")
               for t in tz.state.opt_state[m].values()]
    out["zero_moment_bytes"] = (
        sum(t.numel() * t.element_size() for t in moments),
        sum(t.untyped_storage().nbytes() for t in moments))
    out["collective_s"] = tz.dp.collective_s
    del tz
    # ZeRO in small buckets: the update and its all-gather run a bucket
    # of params at a time, the gradient mean a bucket of its own size
    import ripor_tpu_torch.train.trainer as trainer_mod
    default, trainer_mod.GRAD_BUCKET = trainer_mod.GRAD_BUCKET, 2048
    try:
        out["small_buckets"] = len(trainer_mod._buckets(list(sd.values())))
        _, out["zero_small_logs"], out["zero_small"] = run(zcfg, batches)
    finally:
        trainer_mod.GRAD_BUCKET = default
    _, _, drop = run(tcfg, batches[:2], c=inputs["drop_cfg"])
    out["drop_checksum"] = checksum(drop)
    _, _, out["prefetch"] = run(tcfg, list(device_prefetch(
        iter(batches), device="cpu", sharding=mesh)))
    # grad_accum=2: each rank's slice of both micro-batches
    micro = [{k: v.reshape((2, -1) + v.shape[1:]) for k, v in b.items()}
             for b in batches]
    _, _, out["accum"] = run(dataclasses.replace(tcfg, grad_accum=2),
                             micro)
    # a ZeRO checkpoint at step 2, resumed on the mesh from a copy (the
    # original is left for the one-process resume)
    ck = os.path.join(root, "ck_mesh")
    run(zcfg, batches[:2], checkpoint_dir=ck, save_steps=2)
    if is_first_process():
        shutil.copytree(ck, ck + "_copy")
    barrier()
    t2, _, out["resumed"] = run(zcfg, batches, checkpoint_dir=ck + "_copy",
                                save_steps=2)
    out["resume_step"] = t2.resume_step
    t3, _, out["from_one"] = run(zcfg, batches,
                                 checkpoint_dir=inputs["ck_one"])
    out["from_one_step"] = t3.resume_step
    del t2, t3
    ws = Workspace(os.path.join(root, "ws"))
    params = stage_train(ws, "dp", RiporModel(cfg, device="cpu"), sd, tcfg,
                         batches, cfg, mesh=mesh)
    out["stage"] = {k: v.numpy() for k, v in params.items()}
    # tests/mp_worker.py's run: seq2seq steps, then each data rank's
    # embedding shard, merged into one mmap by rank 0
    _, logs, s2s = run(TrainConfig(**inputs["s2s_tcfg"]), inputs["s2s"])
    out["s2s"] = (logs[-1]["loss"], checksum(s2s))
    embs = inputs["embs"]
    n_data, d = 2, mesh.get_local_rank("data")
    emb_dir = os.path.join(root, "embs")
    if mesh.get_local_rank("model") == 0:
        rows = host_shard_slice(len(embs), d, n_data)
        writer = ShardWriter(emb_dir, rank=d, chunk_size=6)
        writer.add(embs[rows], [f"d{i}" for i in range(len(embs))][rows])
        writer.finalize()
    barrier()
    out["merged"] = None
    if is_first_process():
        write_plan(emb_dir, nranks=n_data)
        merge_to_mmap(emb_dir, os.path.join(root, "mmap"),
                      d=embs.shape[1])
        arr, ids = open_mmap(os.path.join(root, "mmap"))
        out["merged"] = (np.asarray(arr).copy(), list(ids))
    out["param_blocks"] = {k: v.numpy() for k, v in shard_params(
        sd, mesh).items()}
    return out


JOBS = {"decode": job_decode, "mesh": job_mesh, "serve": job_serve,
        "train": job_train}


def main():
    rank, world, workdir, job = (int(sys.argv[1]), int(sys.argv[2]),
                                 Path(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, str(REPO))
    import torch
    torch.set_num_threads(1)
    from ripor_tpu_torch.core.mesh import (MeshSpec, create_mesh,
                                           distributed_init)
    distributed_init(f"file://{workdir / 'store'}", num_processes=world,
                     process_id=rank, backend="gloo")
    mesh = create_mesh(MeshSpec(data=DATA, model=MODEL), device_type="cpu")
    with open(workdir / "inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    inputs["workdir"] = str(workdir)
    result = JOBS[job](mesh, inputs)
    with open(workdir / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
