"""The port's mesh (core/mesh.py on torch.distributed), its sharding
rules (parallel/sharding.py), and the engine and dense_topk on a mesh.

``MeshSpec`` and the spec tables are held against the JAX package's
directly. The rest runs in one 4-rank gloo world (data=2 x model=2,
tests/torch_mesh_ranks.py) and is held against the same package's
single-device results at the JAX package's bars
(tests/test_serve.py:106-127, tests/test_eval.py:155-176 and the mesh
half of :262)."""
import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from ripor_tpu.core.mesh import MeshSpec as JaxMeshSpec
from ripor_tpu.evaluation.retriever import dense_topk as jax_dense_topk
from ripor_tpu.models import ripor_small as jax_ripor_small
from ripor_tpu.parallel.sharding import (
    decode_params_pspec_tree as jax_decode_specs)
from ripor_tpu.parallel.sharding import params_pspec_tree as jax_specs
from ripor_tpu_torch.core.mesh import MeshSpec
from ripor_tpu_torch.data.tokenizer import HashTokenizer
from ripor_tpu_torch.models import ripor_small
from ripor_tpu_torch.parallel.sharding import (decode_params_pspec_tree,
                                               params_pspec_tree)
from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
from ripor_tpu_torch.trie import build_trie
from torch_parity import (port_name_and_flip, port_state_dict,
                          seeded_params)

QUERIES = ["what is jax", "tpu systolic array", "residual quantization"]
ENGINE = dict(num_beams=5, topk=7, max_length=6, max_delay_ms=50.0,
              param_dtype=None)


def _dense_data():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((4, 8)).astype(np.float32)
    d = rng.standard_normal((64, 8)).astype(np.float32)  # 64 % 2 == 0
    rng = np.random.default_rng(11)
    db = rng.standard_normal((64, 16)).astype(np.float32)
    db[:, 0] += np.arange(64) * 0.5          # separate the score scale
    qb = rng.standard_normal((3, 16)).astype(np.float32)
    qb[:, 0] += 4.0
    return q, d, qb, db


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg = ripor_small(M=4, K=8)
    sd = port_state_dict(seeded_params(cfg, 7), cfg)
    doc_codes = np.random.default_rng(7).integers(0, 8, (40, 4))
    inputs = {"state_dict": sd,
              "engine": (cfg, sd, doc_codes, QUERIES,
                         dict(ENGINE, batch_sizes=(4,))),
              "dense": _dense_data()}
    handle = ranks.start("mesh", inputs, tmp_path_factory.mktemp("mesh"))
    # single-device references, while the ranks run
    docids = [f"d{i}" for i in range(len(doc_codes))]
    eng = RetrievalEngine(cfg, sd, HashTokenizer(100),
                          build_trie(doc_codes, 8), docids,
                          ServeConfig(**ENGINE, batch_sizes=(1, 2, 4)),
                          device="cpu")
    want = {"engine": eng.retrieve_batch(QUERIES)}
    q, d, qb, db = _dense_data()
    want["dense_bf16"] = jax_dense_topk(qb, db, k=5)
    return ranks.collect(handle), want, sd


def test_mesh_spec_resolve_and_its_errors():
    for spec, n in ((MeshSpec(), 8), (MeshSpec(model=2), 8),
                    (MeshSpec(data=2, model=2), 4)):
        j = JaxMeshSpec(spec.data, spec.model).resolve(n)
        assert spec.resolve(n) == MeshSpec(j.data, j.model)
    for args, n in (((-1, 3), 8), ((3, 2), 8)):
        with pytest.raises(ValueError) as want:
            JaxMeshSpec(*args).resolve(n)
        with pytest.raises(ValueError) as got:
            MeshSpec(*args).resolve(n)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("table", ["train", "decode"])
def test_spec_tables_match_jax(table):
    """Every param of ripor_small: the port's spec is the JAX package's,
    reversed where the port's Linear weight is the transpose of the flax
    kernel."""
    cfg = jax_ripor_small()
    params = seeded_params(cfg, 0)
    jax_fn, port_fn = ((jax_specs, params_pspec_tree) if table == "train"
                       else (jax_decode_specs, decode_params_pspec_tree))
    port = port_fn(port_state_dict(params, cfg))
    seen = set()
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jax_fn(params), is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        name, flip = port_name_and_flip(path)
        leaf = params
        for p in path:
            leaf = leaf[p.key]
        want = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        want = want[::-1] if flip else want
        got = port[name] + (None,) * (leaf.ndim - len(port[name]))
        assert got == want, (name, got, want)
        seen.add(name)
    assert seen == set(port)
    split = {k for k, v in port.items() if "model" in v}
    assert "decoder.layers.0.self_attn.q.weight" in split
    assert ("shared.weight" in split) == (table == "train")
    assert ("decoder.rel_bias.rel_embedding" in split) == (table == "decode")


def test_rank_layout(world):
    got, _, _ = world
    for r, out in enumerate(got):
        assert out["coords"] == (r, r // 2, r % 2)
        assert out["sizes"] == (2, 2)
        assert out["process"] == (4, r == 0)
        assert out["placements"] == [
            "(Replicate(), Shard(dim=1))", "(Replicate(), Replicate())",
            "(Shard(dim=0), Replicate())", "(Shard(dim=0), Replicate())"]


def test_tp_sum_keeps_the_dtype(world):
    got, _, _ = world
    for dt in (torch.bfloat16, torch.float32):
        a = torch.full((3,), 1.0, dtype=dt)
        b = torch.full((3,), 1.0 + 2 ** -7, dtype=dt)
        for out in got:
            dtype, value = out[f"sum_{dt}"]
            assert dtype == dt
            np.testing.assert_array_equal(value, (a + b).float())


def test_shard_batch(world):
    got, _, _ = world
    for r, out in enumerate(got):
        rows = np.arange(4) + 4 * (r // 2)
        np.testing.assert_array_equal(out["batch"]["ids"][:, 0], rows)
        np.testing.assert_array_equal(out["batch"]["rest"][0].numpy(), rows)
        assert "does not divide the 'data' axis (2)" in out["batch_error"]


def test_shard_decode_params(world):
    """The two model ranks' slices put back together are the whole
    state_dict; the split dim is the one the decode table names."""
    got, _, sd = world
    specs = decode_params_pspec_tree(sd)
    for data in (0, 1):
        a, b = (got[2 * data + m]["decode_slice"] for m in (0, 1))
        for name, full in sd.items():
            if "model" in specs[name]:
                dim = specs[name].index("model")
                np.testing.assert_array_equal(
                    np.concatenate([a[name], b[name]], axis=dim), full)
                assert a[name].shape[dim] * 2 == full.shape[dim]
            else:
                np.testing.assert_array_equal(a[name], full)
                np.testing.assert_array_equal(b[name], full)


def test_mesh_engine_matches_single_device(world):
    got, want, _ = world
    for out in got:
        assert len(out["engine"]) == len(QUERIES)
        for g, w in zip(out["engine"], want["engine"]):
            assert [d for d, _ in g] == [d for d, _ in w]
            np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                       rtol=1e-4)
        assert "data" in out["rung_error"]
    # rank 0 queues a request (failed by stop()); the other ranks refuse
    assert got[0]["submit"] == "Future"
    for out in got[1:]:
        assert "first rank" in out["submit_error"]


def test_dense_topk_on_mesh(world):
    got, _, _ = world
    q, d, _, _ = _dense_data()
    brute = q @ d.T
    want_i = np.argsort(-brute, axis=1)[:, :6]
    want_s = np.take_along_axis(brute, want_i, axis=1)
    for out in got:
        for key in ("dense_f32", "dense_blocks"):
            s, i = out[key]
            np.testing.assert_array_equal(np.sort(i, 1), np.sort(want_i, 1))
            np.testing.assert_allclose(np.sort(s, 1), np.sort(want_s, 1),
                                       rtol=1e-5)
        # 63 rows do not divide the data axis: the single-device route
        s, i = out["dense_ragged"]
        want63 = np.argsort(-brute[:, :63], axis=1)[:, :6]
        np.testing.assert_array_equal(np.sort(i, 1), np.sort(want63, 1))


def test_dense_topk_bf16_device_corpus_on_mesh(world):
    got, want, _ = world
    for out in got:
        np.testing.assert_array_equal(out["dense_bf16"][1],
                                      want["dense_bf16"][1])


def test_int8_corpus_refused_on_mesh(world):
    got, _, _ = world
    for out in got:
        assert "Int8Corpus" in out["int8_error"]
