"""Data-parallel training on a mesh: ``Trainer(mesh=)`` replicated and
with ZeRO opt-state sharding (``shard_opt_state``), ``stage_train(mesh=)``,
``device_prefetch(sharding=)``, checkpoints across mesh and one process,
and the spec rules of parallel/sharding.py, in one 4-rank gloo world
(data=2 x model=2, tests/torch_mesh_ranks.py's ``train`` job).

Bars, from the JAX package's tests: the mesh trainer against the JAX
``Trainer(mesh=mesh8)`` from the same params at dropout 0, and ZeRO
against replicated, at tests/test_train.py:252-293's rtol 2e-4 / atol
1e-6 — here ZeRO is bit-equal (the same elementwise update on the same
averaged gradient); two data ranks against one process at
tests/test_multiprocess.py's rel 2e-4. The losses are means over rows,
so a mean over equal data slices is the global batch's (checked for all
ten LOSS_FNS at rtol 1e-5)."""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_mesh_ranks as ranks
from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.models import ripor_small as jax_ripor_small
from ripor_tpu.parallel.sharding import \
    opt_state_pspec_tree as jax_opt_specs
from ripor_tpu.train import TrainConfig as JaxTrainConfig
from ripor_tpu.train import Trainer as JaxTrainer
from ripor_tpu.train import make_optimizer as jax_make_optimizer
from ripor_tpu_torch.models import (BertCrossEncoder, RiporModel,
                                    T5DenseEncoder, T5SeqCrossEncoder,
                                    init_params, params_from_jax,
                                    ripor_small)
from ripor_tpu_torch.parallel import (opt_moment_spec, opt_state_pspec_tree,
                                      params_pspec_tree)
from ripor_tpu_torch.train import LOSS_FNS, AdamW, TrainConfig, Trainer
from torch_parity import port_name_and_flip, port_state_dict, seeded_params

M, K, B, L = 8, 16, 8, 12
TCFG = dict(loss_type="t5seq_aq_encoder_margin_mse", learning_rate=1e-3,
            total_steps=10)
S2S = dict(loss_type="t5seq_aq_encoder_seq2seq", learning_rate=1e-3,
           total_steps=4)


def _margin_batches(rng, n):
    """tests/test_train.py::marginmse_batch's batches, numpy."""
    out = []
    for _ in range(n):
        ids = rng.integers(1, 100, (B, L)).astype(np.int32)
        out.append({"query_ids": ids, "query_mask": np.ones_like(ids),
                    "pos_codes": rng.integers(0, K, (B, M)).astype(np.int32),
                    "neg_codes": rng.integers(0, K, (B, M)).astype(np.int32),
                    "teacher_pos_score": rng.standard_normal(B).astype(
                        np.float32),
                    "teacher_neg_score": rng.standard_normal(B).astype(
                        np.float32)})
    return out


def _s2s_batches(rng, n):
    """tests/mp_worker.py's seq2seq batches."""
    out = []
    for _ in range(n):
        ids = rng.integers(2, 64, (B, L)).astype(np.int32)
        out.append({"query_ids": ids, "query_mask": np.ones_like(ids),
                    "codes": rng.integers(0, K, (B, M)).astype(np.int32)})
    return out


def _one_process(cfg, sd, tcfg, batches, **kw):
    trainer = Trainer(RiporModel(cfg, device="cpu"), tcfg, sd, **kw)
    state, metrics = trainer.run(batches, seed=0)
    return trainer, {k: v.detach().numpy().copy()
                     for k, v in state.params.items()}, metrics


@pytest.fixture(scope="module")
def world(tmp_path_factory, mesh8):
    cfg = ripor_small(M=M, K=K)
    params = seeded_params(cfg, 0)
    sd = port_state_dict(params, cfg)
    rng = np.random.default_rng(0)
    batches = _margin_batches(rng, 4)
    s2s = _s2s_batches(rng, 4)
    root = tmp_path_factory.mktemp("train")
    ck_one = root / "ck_one"
    _one_process(cfg, sd, TrainConfig(**TCFG), batches[:2],
                 checkpoint_dir=str(ck_one), save_steps=2)
    drop = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, dropout_rate=0.1))
    embs = np.arange(20 * 8, dtype=np.float32).reshape(20, 8)
    handle = ranks.start("train", dict(
        cfg=cfg, sd=sd, batches=batches, tcfg=TCFG, drop_cfg=drop,
        ck_one=str(ck_one), s2s=s2s, s2s_tcfg=S2S, embs=embs), root)
    # the references, while the ranks run
    want = {}
    jlogs = []
    jt = JaxTrainer(JaxRiporModel(jax_ripor_small(M=M, K=K)),
                    JaxTrainConfig(**TCFG), params, mesh=mesh8,
                    log_fn=lambda m, s: jlogs.append(float(m["loss"])))
    jstate, _ = jt.run(iter(batches), jax.random.PRNGKey(0), log_every=1)
    want["jax_logs"] = jlogs
    want["jax"] = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jstate.params), cfg).items()}
    _, want["one"], _ = _one_process(cfg, sd, TrainConfig(**TCFG), batches)
    _, p, metrics = _one_process(cfg, sd, TrainConfig(**S2S), s2s)
    want["s2s"] = (float(metrics["loss"]),
                   float(sum(np.abs(v).sum(dtype=np.float64)
                             for v in p.values())))
    got = ranks.collect(handle)
    return got, want, dict(cfg=cfg, sd=sd, params=params, batches=batches,
                           root=root, embs=embs)


def _close(got, want, rtol=2e-4, atol=1e-6):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=k)


def _equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_mesh_trainer_matches_jax_mesh_trainer(world):
    got, want, _ = world
    np.testing.assert_allclose([m["loss"] for m in got[0]["rep_logs"]],
                               want["jax_logs"], rtol=2e-4, atol=1e-6)
    _close(got[0]["rep"], want["jax"])
    for out in got:
        _equal(out["rep"], got[0]["rep"])
        assert out["rep_logs"] == got[0]["rep_logs"]


def test_zero_is_bit_equal_to_replicated(world):
    got, _, w = world
    specs = opt_state_pspec_tree(AdamW(TrainConfig()).init(w["sd"]),
                                 w["sd"])
    for out in got:
        _equal(out["zero"], out["rep"])
        assert out["zero_logs"] == out["rep_logs"]
        assert out["zero_specs"] == specs["mu"]
        split = [k for k, shape in out["zero_blocks"].items()
                 if "data" in specs["mu"][k]
                 and np.prod(shape) * 2 <= w["sd"][k].numel()
                 and w["sd"][k].numel() >= 64]
        assert "shared.weight" in split and len(split) > len(w["sd"]) // 2


def test_zero_moments_hold_only_their_blocks(world):
    """Each ZeRO moment block owns its storage: none is a view that keeps
    the whole moment alive, so a rank holds about half the moment bytes
    of replicated (data=2)."""
    got, _, w = world
    whole = 2 * sum(v.numel() * v.element_size() for v in w["sd"].values())
    for out in got:
        blocks, storage = out["zero_moment_bytes"]
        assert storage == blocks < 0.6 * whole


def test_zero_in_small_buckets_is_bit_equal_to_replicated(world):
    """ZeRO's update and all-gather run a bucket of params at a time (the
    gradient mean too): many small buckets give the replicated run's
    params and logs bit for bit."""
    got, _, _ = world
    for out in got:
        assert out["small_buckets"] > 10
        _equal(out["zero_small"], out["rep"])
        assert out["zero_small_logs"] == out["rep_logs"]


def test_dropout_keeps_every_rank_equal(world):
    got, _, _ = world
    assert len({out["drop_checksum"] for out in got}) == 1


def test_prefetch_sharding_and_stage_train_on_mesh(world):
    got, _, w = world
    for out in got:
        _equal(out["prefetch"], out["rep"])
        _equal(out["stage"], out["rep"])
    saved = torch.load(w["root"] / "ws" / "checkpoints" / "dp" / "params.pt",
                       weights_only=True)
    _equal({k: v.numpy() for k, v in saved.items()}, got[0]["rep"])


def test_grad_accum_on_mesh_matches_full_batch(world):
    """grad_accum=2 on the mesh (each rank's slice of both micro-batches)
    against the full batch, at tests/test_train.py's accumulation bar."""
    got, _, _ = world
    for out in got:
        _close(out["accum"], out["rep"], rtol=1e-4, atol=1e-6)


def test_zero_checkpoint_resumes_on_mesh_and_in_one_process(world):
    """A ZeRO checkpoint written on the mesh at step 2 holds whole
    moments; resumed on the mesh it continues bit-equal, in one process
    within the bar. A one-process checkpoint resumes on the mesh."""
    got, want, w = world
    for out in got:
        assert out["resume_step"] == 2 and out["from_one_step"] == 2
        _equal(out["resumed"], out["zero"])
        _close(out["from_one"], want["one"])
    ck = w["root"] / "ck_mesh"
    saved = torch.load(ck / "2" / "state.pt", weights_only=True)
    for k, v in w["sd"].items():
        assert saved["opt_state"]["mu"][k].shape == v.shape
    again = w["root"] / "ck_mesh_one"
    shutil.copytree(ck, again)
    trainer, params, _ = _one_process(w["cfg"], w["sd"], TrainConfig(**TCFG),
                                      w["batches"],
                                      checkpoint_dir=str(again))
    assert trainer.resume_step == 2
    _close(params, want["one"])
    _close(params, got[0]["zero"])


def test_two_data_ranks_against_one_process(world):
    """tests/test_multiprocess.py at toy size: seq2seq steps on the mesh
    against one process, and the data ranks' embedding shards merged into
    one mmap by rank 0 alone."""
    got, want, w = world
    for out in got:
        assert out["s2s"][0] == pytest.approx(got[0]["s2s"][0], rel=1e-6)
        assert out["s2s"][1] == pytest.approx(got[0]["s2s"][1], rel=1e-6)
    assert got[0]["s2s"][0] == pytest.approx(want["s2s"][0], rel=2e-4)
    assert got[0]["s2s"][1] == pytest.approx(want["s2s"][1], rel=2e-4)
    arr, ids = got[0]["merged"]
    np.testing.assert_array_equal(arr, w["embs"])
    assert ids == [f"d{i}" for i in range(20)]
    assert all(out["merged"] is None for out in got[1:])


def test_shard_params_blocks(world):
    """The two model ranks' blocks by the training table put back
    together are the whole params (the vocab dim of shared.weight
    split)."""
    got, _, w = world
    specs = params_pspec_tree(w["sd"])
    assert specs["shared.weight"] == ("model", None)
    for data in (0, 1):
        a, b = (got[2 * data + m]["param_blocks"] for m in (0, 1))
        for name, full in w["sd"].items():
            if "model" in specs[name]:
                dim = specs[name].index("model")
                np.testing.assert_array_equal(
                    np.concatenate([a[name], b[name]], axis=dim), full)
            else:
                np.testing.assert_array_equal(a[name], full)


def test_opt_specs_match_jax():
    """opt_state_pspec_tree (and so opt_moment_spec) against the JAX
    package's, leaf by leaf, reversed where the port's Linear weight is
    the transpose of the flax kernel."""
    cfg = jax_ripor_small(M=M, K=K)
    params = seeded_params(cfg, 0)
    sd = port_state_dict(params, cfg)
    port = opt_state_pspec_tree(AdamW(TrainConfig()).init(sd), sd)
    jspecs = jax_opt_specs(jax_make_optimizer(JaxTrainConfig()).init(params),
                           params)
    seen = set()
    for path, spec in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        keys = [getattr(p, "name", getattr(p, "key", None)) for p in path]
        moment = next((k for k in keys if k in ("mu", "nu")), None)
        if moment is None:
            assert spec == PartitionSpec()
            continue
        rest = path[keys.index(moment) + 1:]
        name, flip = port_name_and_flip(rest)
        leaf = params
        for p in rest:
            leaf = leaf[p.key]
        want = tuple(spec) + (None,) * (leaf.ndim - len(spec))
        want = want[::-1] if flip else want
        got = port[moment][name]
        assert got + (None,) * (leaf.ndim - len(got)) == want, (name, got)
        assert opt_moment_spec(params_pspec_tree(sd)[name], sd[name]) == got
        seen.add((moment, name))
    assert seen == {(m, k) for m in ("mu", "nu") for k in sd}
    assert port["count"] == ()
    assert port["mu"]["shared.weight"] == ("model", "data")
    assert port["mu"]["encoder.layers.0.attn_norm.scale"] == ("data",)


# ---- the losses are means over rows ----

BERT = dict(vocab_size=120, d_model=48, num_layers=2, num_heads=4, d_ff=96,
            max_position=32)
LB, LM = 4, 16


def _rank_batch(rng):
    b = {"query_ids": rng.integers(1, 100, (LB, L)).astype(np.int32),
         "query_mask": np.ones((LB, L), np.int32),
         "pos_codes": rng.integers(0, K, (LB, LM)).astype(np.int32),
         "neg_codes": rng.integers(0, K, (LB, LM)).astype(np.int32)}
    b["query_mask"][1, -4:] = 0
    for key in ("teacher", "smtid_4_teacher", "smtid_8_teacher"):
        for side in ("pos", "neg"):
            b[f"{key}_{side}_score"] = rng.standard_normal(LB).astype(
                np.float32)
    return b


def _loss_case(name, rng):
    """(model, batch) of a LOSS_FNS entry, B=4, random params."""
    ripor = ripor_small(M=LM, K=K)
    ids = rng.integers(5, 100, (LB, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, -5:] = 0
    codes = rng.integers(0, K, (LB, LM)).astype(np.int32)
    labels = np.array([1, 0, 1, 0], np.float32)
    if name == "bert_bce":
        return BertCrossEncoder(**BERT, device="cpu"), {
            "input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros_like(ids), "labels": labels}
    if name == "t5seq_bce":
        return T5SeqCrossEncoder(ripor, device="cpu"), {
            "query_ids": ids, "query_mask": mask, "codes": codes,
            "labels": labels}
    if name in ("margin_mse", "kldiv"):
        batch = {}
        for side in ("query", "pos_doc", "neg_doc"):
            batch[f"{side}_ids"] = rng.integers(5, 100, (LB, L)).astype(
                np.int32)
            batch[f"{side}_mask"] = mask
        for side in ("pos", "neg"):
            batch[f"teacher_{side}_score"] = rng.standard_normal(LB).astype(
                np.float32)
        return T5DenseEncoder(ripor.t5, device="cpu"), batch
    batch = _rank_batch(rng)
    if name == "t5seq_aq_encoder_seq2seq":
        batch = {"query_ids": ids, "query_mask": mask, "codes": codes}
    elif name.endswith("_and_seq2seq"):
        batch.update(s2s_query_ids=ids, s2s_query_mask=mask, s2s_codes=codes)
    elif name == "t5seq_pretrain_margin_mse":
        batch.update(pos_doc_ids=ids, neg_doc_ids=ids[::-1].copy(),
                     pos_doc_mask=mask, neg_doc_mask=mask[::-1].copy(),
                     pos_prefix_codes=batch.pop("pos_codes")[:, :3],
                     neg_prefix_codes=batch.pop("neg_codes")[:, :3])
    return RiporModel(ripor, device="cpu"), batch


@pytest.mark.parametrize("name", sorted(LOSS_FNS))
def test_every_loss_is_a_mean_of_rows(name):
    """Each loss of the batch equals the mean of its two halves' losses:
    no term mixes rows, so the data ranks' mean loss (and gradient) is
    the global batch's."""
    model, batch = _loss_case(name, np.random.default_rng(3))
    with torch.no_grad():
        model.load_state_dict(init_params(
            model, torch.Generator().manual_seed(1), device="cpu"))
    fn = LOSS_FNS[name]

    def loss(rows):
        b = {k: torch.as_tensor(v[rows]) for k, v in batch.items()}
        with torch.no_grad():
            return {k: float(v) for k, v in fn(model, b, train=False).items()}
    whole, a, b = loss(slice(0, LB)), loss(slice(0, 2)), loss(slice(2, LB))
    assert set(whole) == set(a) == set(b)
    for k, v in whole.items():
        assert (a[k] + b[k]) / 2 == pytest.approx(v, rel=1e-5), k
