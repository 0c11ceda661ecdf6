"""The port stands alone: it imports no JAX, no transformers and no
ripor_tpu module (nor, at import, tensorstore, tokenizers or safetensors,
which the card's machine may lack), builds no kernel at import, runs on
CUDA unless told otherwise, and launches no kernel for CPU tensors."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "ripor_tpu_torch"


def _modules():
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_jax_flax_or_reference_modules_imported():
    mods = _modules()
    assert {"ripor_tpu_torch.ops.megarow",
            "ripor_tpu_torch.ops.step_attention",
            "ripor_tpu_torch.ops.attend_reorder",
            "ripor_tpu_torch.train.losses",
            "ripor_tpu_torch.train.regularizers",
            "ripor_tpu_torch.train.trainer",
            "ripor_tpu_torch.train.checkpoint",
            "ripor_tpu_torch.data.collators",
            "ripor_tpu_torch.data.loader",
            "ripor_tpu_torch.utils.observability",
            "ripor_tpu_torch.core.precision",
            "ripor_tpu_torch.pipeline.e2e",
            "ripor_tpu_torch.data.emb_store",
            "ripor_tpu_torch.quantize.kmeans",
            "ripor_tpu_torch.quantize.rq",
            "ripor_tpu_torch.quantize.pq",
            "ripor_tpu_torch.evaluation.retriever",
            "ripor_tpu_torch.evaluation.dev_eval",
            "ripor_tpu_torch.evaluation.hnsw",
            "ripor_tpu_torch.evaluation.bm25",
            "ripor_tpu_torch.models.bert",
            "ripor_tpu_torch.models.cross_encoder",
            "ripor_tpu_torch.models.dense_encoder",
            "ripor_tpu_torch.models.import_hf",
            "ripor_tpu_torch.evaluation.reranker",
            "ripor_tpu_torch.evaluation.rerank_tasks",
            "ripor_tpu_torch.pipeline.datagen",
            "ripor_tpu_torch.pipeline.flywheel",
            "ripor_tpu_torch.pipeline.runner",
            "ripor_tpu_torch.pipeline.full_recipe",
            "ripor_tpu_torch.train.calibrate",
            "ripor_tpu_torch.core.mesh",
            "ripor_tpu_torch.parallel",
            "ripor_tpu_torch.parallel.reference",
            "ripor_tpu_torch.parallel.sharding"} <= set(mods)
    r = _run(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "ripor_tpu", "tensorstore",
                                            "tokenizers", "transformers",
                                            "safetensors"))
        print("BAD", bad)
        assert not bad, bad
    """)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_does_not_call_nvcc():
    r = _run(f"""
        import importlib, subprocess
        calls = []
        real = subprocess.Popen.__init__
        def spy(self, args, *a, **k):
            calls.append(args)
            return real(self, args, *a, **k)
        subprocess.Popen.__init__ = spy
        for m in {_modules()!r}:
            importlib.import_module(m)
        import chip_smoke
        from ripor_tpu_torch.ops import _build
        assert not any("nvcc" in str(c) for c in calls), calls
        assert not _build._libs
    """)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.models import init_params, ripor_small
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import build_trie

    cfg = ripor_small(M=8, K=8)
    for kw in ({}, dict(megarow=False), dict(deferred=False)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_beam_search_fn(cfg, 4, **kw)
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    codes = np.random.default_rng(0).integers(0, 8, (20, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalEngine(cfg, sd, HashTokenizer(100), build_trie(codes, 8),
                        [str(i) for i in range(20)],
                        ServeConfig(num_beams=4, topk=4, batch_sizes=(1,)))
    from ripor_tpu_torch.evaluation.reranker import (load_bert_teacher,
                                                     rerank_query_smtids)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_bert_teacher("no_checkpoint_here", 100)
    with pytest.raises(RuntimeError, match="CUDA"):
        rerank_query_smtids(cfg, sd, HashTokenizer(100), None, {})
    from ripor_tpu_torch.pipeline.flywheel import (beam_prefix_candidates,
                                                   datagen_round)
    from ripor_tpu_torch.pipeline.full_recipe import run_full_recipe
    docids = [str(i) for i in range(20)]
    with pytest.raises(RuntimeError, match="CUDA"):
        beam_prefix_candidates(cfg, sd, HashTokenizer(100), ["q"], ["a"],
                               codes, docids, prefix_len=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        datagen_round(cfg, sd, HashTokenizer(100), {"q": "a"},
                      {"q": docids[:3]}, codes, docids, dict, prefix_len=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_full_recipe(str(tmp_path / "ws"), "docs", "queries", "qrel")
    assert not (tmp_path / "ws").exists()


def test_mesh_entry_points_default_to_cuda_and_raise_without_it():
    """In a process of its own: a one-rank CPU mesh leaves a process
    group behind."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    r = _run("""
        import numpy as np, pytest, torch
        from ripor_tpu_torch.core.mesh import (create_mesh,
                                               distributed_init, local_mesh)
        from ripor_tpu_torch.data.tokenizer import HashTokenizer
        from ripor_tpu_torch.decode import (make_sharded_beam_search_fn,
                                            make_tp_beam_search_fn)
        from ripor_tpu_torch.evaluation.retriever import dense_topk
        from ripor_tpu_torch.models import init_params, ripor_small
        from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
        from ripor_tpu_torch.trie import build_trie

        for call in (create_mesh, local_mesh,
                     lambda: distributed_init("localhost:1", 2, 0)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
        mesh = create_mesh(device_type="cpu")
        assert mesh.shape == (1, 1)
        with pytest.raises(RuntimeError, match="already initialised"):
            distributed_init("localhost:1", 2, 0, backend="gloo")
        cfg = ripor_small(M=8, K=8)
        for make in (make_sharded_beam_search_fn, make_tp_beam_search_fn):
            with pytest.raises(RuntimeError, match="CUDA"):
                make(cfg, 4, mesh)
        sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        codes = np.random.default_rng(0).integers(0, 8, (20, 8))
        with pytest.raises(RuntimeError, match="CUDA"):
            RetrievalEngine(cfg, sd, HashTokenizer(100), build_trie(codes, 8),
                            [str(i) for i in range(20)],
                            ServeConfig(num_beams=4, batch_sizes=(1,)),
                            mesh=mesh)
        with pytest.raises(RuntimeError, match="CUDA"):
            dense_topk(np.ones((2, 4), np.float32),
                       np.ones((8, 4), np.float32), 3, mesh=mesh)
        print("OK")
    """)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_cpu_run_launches_no_kernel():
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.models import RiporModel, init_params, ripor_small
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import (build_trie, succinct_tables,
                                      tables_to_torch)

    cfg = ripor_small(M=8, K=8)
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    codes = np.random.default_rng(0).integers(0, 8, (20, 8))
    before = dict(KERNEL_LAUNCHES)
    for quant in (None, "int4"):
        eng = RetrievalEngine(
            cfg, sd, HashTokenizer(100), build_trie(codes, 8),
            [str(i) for i in range(20)],
            ServeConfig(num_beams=4, topk=4, batch_sizes=(2,),
                        kv_cache_quant=quant), device="cpu")
        res = eng.retrieve_batch(["a query", "another one"])
        assert len(res) == 2 and all(len(r) == 4 for r in res)
    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(sd)
    tables = tables_to_torch(succinct_tables(build_trie(codes, 8)), "cpu")
    ids = np.ones((2, 5), np.int64)
    for kw in (dict(megarow=False, kv_cache_quant="int8"),
               dict(deferred=False)):
        fn = make_beam_search_fn(cfg, 4, dtype=torch.float32, device="cpu",
                                 **kw)
        scores, _, _ = fn(model, ids, np.ones_like(ids), tables)
        assert scores.device.type == "cpu"
    assert KERNEL_LAUNCHES == before
