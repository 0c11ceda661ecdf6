"""Ranks of a CPU gloo world for the port's mesh tests
(tests/test_torch_mesh.py, tests/test_torch_sharded_decode.py).

``start(job, inputs, workdir)`` launches WORLD processes, each running
``python tests/torch_mesh_ranks.py RANK WORLD WORKDIR JOB``: the rank
joins the world through ``core.mesh.distributed_init`` on a FileStore in
``workdir`` (no port, so test files may run side by side), builds the
data=2 x model=2 mesh on the CPU, runs ``JOBS[JOB](mesh, inputs)`` with one
thread and writes its result. ``collect`` waits for every rank under a
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
        eng.submit(queries[0])
    except NotImplementedError as e:
        out["submit_error"] = str(e)
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


JOBS = {"decode": job_decode, "mesh": job_mesh}


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
    result = JOBS[job](mesh, inputs)
    with open(workdir / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
