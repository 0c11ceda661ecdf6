"""The port's training slice against the JAX package, on the CPU:
RiporModel's training methods, the six RiporModel losses and their
gradients, the optimizer steps (clipping, schedule, AdamW, accumulation,
L2-SP), the NaN filter, dropout and remat, resume, and carrying a JAX
training state across (ripor_tpu_torch.train, models.convert).

Toy geometry (ripor_small, dropout 0.0, K=16, B=4; M=32 so that
lng_knp_margin_mse runs at m = 8, 16 and 32), f32, inputs from a numpy
seed; the JAX side runs as tests/test_train.py runs it. Tolerances:
model methods atol 1e-5 (and rtol 1e-6: logits reach ~20); loss values and every parameter's gradient rtol
1e-4 / atol 1e-6 (gradients scaled by their tensor's largest entry);
params after optimizer steps, the lr and anchor_drift rtol 1e-5 /
atol 1e-6.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.train import TrainConfig as JaxTrainConfig
from ripor_tpu.train import TrainState as JaxTrainState
from ripor_tpu.train import losses as jax_losses
from ripor_tpu.train import make_optimizer as jax_make_optimizer
from ripor_tpu.train import make_train_step as jax_make_train_step
from ripor_tpu.train import regularizers as jax_regs
from ripor_tpu.train.checkpoint import resize_codebooks as jax_resize
from ripor_tpu_torch.models import (RiporModel, init_params, params_from_jax,
                                    ripor_small, train_state_from_jax)
from ripor_tpu_torch.models.layers import dropout
from ripor_tpu_torch.train import (LOSS_FNS, CheckpointManager, TrainConfig,
                                   Trainer, lr_schedule, resize_codebooks)
from ripor_tpu_torch.train import losses as port_losses
from ripor_tpu_torch.train import regularizers as port_regs
from ripor_tpu_torch.utils import MetricsLogger, StepTimer, peak_flops
from torch_parity import port_model, port_state_dict

M, K, B, L = 32, 16, 4, 12


@pytest.fixture(scope="module")
def world():
    """(cfg, jax model, flax params, a numpy rng for batches); the params
    as tests/torch_parity.py::setup draws them, under jit."""
    cfg = ripor_small(M=M, K=K)
    jm = JaxRiporModel(cfg)
    ids = jnp.zeros((B, L), jnp.int32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, ids, ids,
                              jnp.zeros((B, M), jnp.int32))["params"]
    return cfg, jm, params, np.random.default_rng(1)


def _scores(rng, n=B):
    return rng.standard_normal(n).astype(np.float32)


def rank_batch(rng, m, n=B):
    """A margin-MSE batch with codes of length m and the prefix teacher
    keys lng_knp reads at that m (reference :942-962)."""
    b = {"query_ids": rng.integers(1, 100, (n, L)).astype(np.int32),
         "query_mask": np.ones((n, L), np.int32),
         "pos_codes": rng.integers(0, K, (n, m)).astype(np.int32),
         "neg_codes": rng.integers(0, K, (n, m)).astype(np.int32),
         "teacher_pos_score": _scores(rng, n),
         "teacher_neg_score": _scores(rng, n)}
    b["query_mask"][:, -3:] = 0
    for p in (4, 8, 16):
        if p < m:
            b[f"smtid_{p}_teacher_pos_score"] = _scores(rng, n)
            b[f"smtid_{p}_teacher_neg_score"] = _scores(rng, n)
    return b


def loss_batch(name, rng):
    if name.startswith("lng_knp_margin_mse_") and name[-1].isdigit():
        return rank_batch(rng, int(name.rsplit("_", 1)[1]))
    if name in ("margin_mse", "ranknet"):
        return rank_batch(rng, 8)
    s2s = {"query_ids": rng.integers(1, 100, (B, L)).astype(np.int32),
           "query_mask": np.ones((B, L), np.int32),
           "codes": rng.integers(0, K, (B, 8)).astype(np.int32)}
    if name == "seq2seq_ce":
        return s2s
    if name == "lng_knp_margin_mse_and_seq2seq":
        b = rank_batch(rng, 16)
        b.update({f"s2s_{k}": v for k, v in s2s.items()})
        return b
    assert name == "pretrain_margin_mse"
    b = rank_batch(rng, 4)
    b["pos_doc_ids"] = rng.integers(1, 100, (B, L)).astype(np.int32)
    b["neg_doc_ids"] = rng.integers(1, 100, (B, L)).astype(np.int32)
    b["pos_doc_mask"] = b["neg_doc_mask"] = np.ones((B, L), np.int32)
    b["pos_prefix_codes"] = b.pop("pos_codes")[:, :3]
    b["neg_prefix_codes"] = b.pop("neg_codes")[:, :3]
    return b


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _trainable(params, cfg):
    model = port_model(params, cfg)
    model.requires_grad_(True)
    return model


# ---- the model's training methods ----

METHODS = ("forward", "forward_logits", "rerank_score", "rerank_score_prefix",
           "dense_rep", "dense_rep_prefix", "dense_rep_all",
           "decoder_inputs_from_multi_codes")


@pytest.fixture(scope="module")
def method_cases(world):
    """Inputs of each method and the JAX package's outputs (one jit)."""
    cfg, jm, params, rng = world
    ids = rng.integers(1, 100, (B, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -4:] = 0
    codes = rng.integers(0, K, (B, 12)).astype(np.int32)
    lengths = np.array([1, 5, 12, 7], np.int32)
    args = {"forward": (ids, mask, codes),
            "forward_logits": (ids, mask, codes),
            "rerank_score": (ids, mask, codes),
            "rerank_score_prefix": (ids, mask, codes, lengths),
            "dense_rep": (ids, mask),
            "dense_rep_prefix": (ids, mask, codes[:, :3]),
            "dense_rep_all": (ids, mask, codes),
            "decoder_inputs_from_multi_codes": (
                rng.integers(0, K, (B, 6, 3)).astype(np.int32),)}

    @jax.jit
    def outputs(p, args):
        return {m: jm.apply({"params": p}, *a, method=getattr(
            JaxRiporModel, _jax_name(m))) for m, a in args.items()}
    return args, jax.tree.map(np.asarray, outputs(params, args))


def _jax_name(method):
    return {"forward": "__call__", "dense_rep_prefix": "dense_rep"}.get(
        method, method)


@pytest.mark.parametrize("method", METHODS)
def test_model_method_matches_jax(world, method_cases, method):
    cfg, _, params, _ = world
    args, want = method_cases
    model = port_model(params, cfg)
    name = _jax_name(method)
    fn = model if name == "__call__" else getattr(model, name)
    with torch.no_grad():
        got = fn(*map(torch.as_tensor, args[method]))
    np.testing.assert_allclose(got.numpy(), want[method], rtol=1e-6,
                               atol=1e-5)


# ---- the losses and their gradients ----

LOSSES = ("margin_mse", "seq2seq_ce", "lng_knp_margin_mse_8",
          "lng_knp_margin_mse_16", "lng_knp_margin_mse_32",
          "lng_knp_margin_mse_and_seq2seq", "pretrain_margin_mse", "ranknet")


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_grads_match_jax(world, name):
    cfg, jm, params, rng = world
    batch = loss_batch(name, rng)
    fn = name.rsplit("_", 1)[0] if name[-1].isdigit() else name

    def jax_total(p, batch):
        d = getattr(jax_losses, fn)(jm, p, batch, train=False)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        params, batch)
    model = _trainable(params, cfg)
    got = getattr(port_losses, fn)(model, _torch(batch), train=False)
    assert set(got) == set(want)
    if fn == "lng_knp_margin_mse":
        m = int(name.rsplit("_", 1)[1])
        assert set(got) == {"rank"} | {f"rank_{p}" for p in (4, 8, 16)
                                       if p < m}
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6)
    sum(got.values()).backward()
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(float(jgrads[n].abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale,
                                   jgrads[n].numpy() / scale, rtol=1e-4,
                                   atol=2e-6, err_msg=n)


def test_loss_registry_matches_jax_and_refuses_unported():
    """Every loss type of the JAX registry is ported: the same names, each
    the counterpart of the JAX function (the teacher and baseline losses
    are held against JAX in tests/test_torch_teacher.py), and none left
    refusing."""
    assert set(LOSS_FNS) == set(jax_losses.LOSS_FNS)
    for name, fn in LOSS_FNS.items():
        assert fn.__name__ == jax_losses.LOSS_FNS[name].__name__, name
    assert not hasattr(port_losses, "NOT_PORTED")


# ---- the optimizer steps ----

def _jax_tcfg(**kw):
    base = dict(loss_type="t5seq_aq_encoder_margin_mse", learning_rate=1e-3,
                warmup_steps=1, total_steps=5, grad_clip=0.5,
                weight_decay=0.01)
    base.update(kw)
    return JaxTrainConfig(**base), TrainConfig(**base)


def _jax_run(jm, tcfg, params, batches, anchor=None):
    """States after each step of the JAX trainer's step (jitted)."""
    tx = jax_make_optimizer(tcfg)
    step = jax.jit(jax_make_train_step(jm, tcfg, tx, anchor_params=anchor))
    state = JaxTrainState.create(params, tx)
    out = []
    for i, b in enumerate(batches):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()},
                              jax.random.fold_in(jax.random.PRNGKey(0), i))
        out.append((state, jax.tree.map(np.asarray, metrics)))
    return out, step


@pytest.fixture(scope="module")
def trajectory(world):
    """Four steps of the JAX trainer (warm-up 1, total 5, a clip that
    triggers, weight decay 0.01) on margin-MSE batches."""
    cfg, jm, params, rng = world
    batches = [rank_batch(rng, 8) for _ in range(4)]
    jcfg, pcfg = _jax_tcfg()
    states, step = _jax_run(jm, jcfg, params, batches)
    return dict(batches=batches, states=states, step=step, jcfg=jcfg,
                pcfg=pcfg)


def _assert_params(model, jax_params, cfg, rtol=1e-5, atol=1e-6):
    want = params_from_jax(jax.tree.map(np.asarray, jax_params), cfg)
    for n, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=rtol,
                                   atol=atol, err_msg=n)


def _optax_lr(tcfg, count):
    """The JAX make_optimizer's schedule (ripor_tpu/train/trainer.py:68-72)
    at ``count``."""
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, tcfg.learning_rate,
                               max(tcfg.warmup_steps, 1)),
         optax.linear_schedule(tcfg.learning_rate, 0.0,
                               max(tcfg.total_steps - tcfg.warmup_steps, 1))],
        [tcfg.warmup_steps])
    return float(sched(count))


@pytest.mark.parametrize("warmup,total", [(1, 5), (0, 3), (3, 8)])
def test_lr_schedule_matches_optax(warmup, total):
    jcfg, pcfg = _jax_tcfg(warmup_steps=warmup, total_steps=total)
    for count in range(total + 3):
        np.testing.assert_allclose(lr_schedule(pcfg)(count),
                                   _optax_lr(jcfg, count), rtol=1e-6,
                                   atol=1e-12)


def test_trainer_steps_match_jax(world, trajectory):
    cfg, jm, params, _ = world
    model = RiporModel(cfg, device="cpu")
    trainer = Trainer(model, trajectory["pcfg"], port_state_dict(params, cfg))
    for i in range(3):
        state, metrics = trainer.run(trajectory["batches"][:i + 1], seed=0)
        jstate, jmetrics = trajectory["states"][i]
        assert state.step == i + 1
        assert float(metrics["grad_norm"]) > trajectory["pcfg"].grad_clip
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        _assert_params(model, jstate.params, cfg)
        assert state.opt_state["count"] == int(jstate.opt_state[1][0].count)


@pytest.fixture(scope="module")
def accum_l2sp(world, trajectory):
    """Three JAX steps with grad_accum=2 (the trajectory's batches split in
    two micro-batches) and an L2-SP spring toward the initial params."""
    cfg, jm, params, _ = world
    micro = [{k: v.reshape((2, B // 2) + v.shape[1:]) for k, v in b.items()}
             for b in trajectory["batches"][:3]]
    jcfg, pcfg = _jax_tcfg(grad_accum=2, l2sp_rate=0.2)
    states, _ = _jax_run(jm, jcfg, params, micro, anchor=params)
    return dict(micro=micro, states=states, pcfg=pcfg)


def test_grad_accum_and_l2sp_match_jax(world, accum_l2sp):
    cfg, _, params, _ = world
    states = accum_l2sp["states"]
    model = RiporModel(cfg, device="cpu")
    sd = port_state_dict(params, cfg)
    trainer = Trainer(model, accum_l2sp["pcfg"], sd, anchor_params=sd)
    for i in range(3):
        _, metrics = trainer.run(accum_l2sp["micro"][:i + 1])
        for k in ("loss", "rank", "grad_norm", "anchor_drift"):
            np.testing.assert_allclose(float(metrics[k]),
                                       float(states[i][1][k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        _assert_params(model, states[i][0].params, cfg)
    with pytest.raises(ValueError, match="anchor_params"):
        Trainer(RiporModel(cfg, device="cpu"), accum_l2sp["pcfg"], sd)


def test_grad_accum_matches_full_batch(world, trajectory, accum_l2sp):
    """Two micro-batches of 2 make the step one batch of 4 makes
    (tests/test_train.py:229, dropout 0)."""
    cfg, _, params, _ = world
    sd = port_state_dict(params, cfg)
    models = [RiporModel(cfg, device="cpu") for _ in range(2)]
    _, m_micro = Trainer(models[0], _jax_tcfg(grad_accum=2)[1], sd).run(
        accum_l2sp["micro"][:1])
    _, m_full = Trainer(models[1], trajectory["pcfg"], sd).run(
        trajectory["batches"][:1])
    np.testing.assert_allclose(float(m_micro["loss"]), float(m_full["loss"]),
                               rtol=1e-5)
    for (n, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_nan_filter_shares_the_jax_fault(world, trajectory):
    """A NaN teacher score: both packages zero the total, and both still
    write a non-finite gradient, so the update poisons every parameter
    (ROADMAP.md Queue 3: the NaN filter does not protect the params)."""
    cfg, jm, params, rng = world
    batch = rank_batch(rng, 8)
    batch["teacher_pos_score"][0] = np.nan

    def jax_safe(p, batch):
        t = jax_losses.margin_mse(jm, p, batch, train=False)["rank"]
        return jnp.where(jnp.isfinite(t), t, 0.0)

    jgrads = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(
        jax_safe))(params, batch)), cfg)
    jstate, jmetrics = trajectory["step"](
        JaxTrainState.create(params, jax_make_optimizer(trajectory["jcfg"])),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    model = RiporModel(cfg, device="cpu")
    trainer = Trainer(model, trajectory["pcfg"], port_state_dict(params, cfg))
    _, metrics = trainer.run([batch])
    assert np.isnan(float(metrics["loss"])) and np.isnan(
        float(jmetrics["loss"]))
    assert np.isnan(float(metrics["grad_norm"])) and np.isnan(
        float(jmetrics["grad_norm"]))
    nonfinite = 0
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(np.isnan(p.grad.numpy()),
                                      np.isnan(jgrads[n].numpy()), n)
        nonfinite += int(np.isnan(p.grad.numpy()).sum())
        assert np.isnan(p.detach().numpy()).all(), n
    assert nonfinite > 0
    assert all(np.isnan(np.asarray(x)).all()
               for x in jax.tree.leaves(jstate.params))


# ---- dropout and remat ----

def _dropout_cfg(remat=False):
    cfg = ripor_small(M=6, K=8)
    t5 = cfg.t5.__class__(**{**cfg.t5.__dict__, "dropout_rate": 0.1,
                             "remat_layers": remat})
    return cfg.__class__(**{**cfg.__dict__, "t5": t5})


@pytest.fixture(scope="module")
def dropout_world():
    cfg = _dropout_cfg()
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(1, 100, (3, 9)))
    codes = torch.as_tensor(rng.integers(0, 8, (3, 6)))
    return cfg, sd, ids, torch.ones_like(ids), codes


def _model(cfg, sd):
    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(sd)
    return model


def test_dropout_follows_the_generator(dropout_world):
    cfg, sd, ids, mask, codes = dropout_world
    model = _model(cfg, sd)

    def run(seed):
        return model(ids, mask, codes, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))
    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="generator"):
        model(ids, mask, codes, deterministic=False)


def test_deterministic_equals_eval(dropout_world):
    cfg, sd, ids, mask, codes = dropout_world
    eval_cfg = ripor_small(M=6, K=8)           # dropout_rate 0.0
    want = _model(eval_cfg, sd)(ids, mask, codes)
    got = _model(cfg, sd)(ids, mask, codes, deterministic=True,
                          generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, want)


def test_dropout_zero_fraction_near_rate():
    x = torch.ones(400, 500)
    y = dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    zeros = float((y == 0).float().mean())
    assert abs(zeros - 0.1) < 0.005, zeros
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    assert torch.equal(dropout(x, 0.1, True, None), x)


def test_remat_replays_dropout_masks(dropout_world):
    """remat_layers recomputes each layer in the backward pass; its masks
    come from a generator seeded before the layer, so the gradients equal
    those of the stored activations."""
    _, sd, ids, mask, codes = dropout_world
    grads = []
    for remat in (False, True):
        model = _model(_dropout_cfg(remat), sd)
        model.requires_grad_(True)
        out = model.rerank_score(ids, mask, codes, deterministic=False,
                                 generator=torch.Generator().manual_seed(3))
        out.square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=0,
                                   msg=n)


# ---- resume and carrying a JAX run across ----

def test_resume_is_bit_equal(dropout_world, tmp_path):
    """3 steps, a checkpoint, a new Trainer and 3 more steps equal 6
    uninterrupted steps bit for bit on the CPU, with dropout on (the step's
    generator depends on (seed, step) alone)."""
    cfg, sd, ids, mask, codes = dropout_world
    tcfg = TrainConfig(loss_type="t5seq_aq_encoder_seq2seq",
                       learning_rate=1e-3)
    batch = {"query_ids": ids, "query_mask": mask, "codes": codes}
    batches = [batch] * 6
    full_model = RiporModel(cfg, device="cpu")
    full, _ = Trainer(full_model, tcfg, sd).run(iter(batches), seed=7)

    ck = tmp_path / "ck"
    Trainer(RiporModel(cfg, device="cpu"), tcfg, sd, checkpoint_dir=ck,
            save_steps=3).run(iter(batches[:3]), seed=7)
    t2 = Trainer(RiporModel(cfg, device="cpu"), tcfg, sd, checkpoint_dir=ck,
                 save_steps=3)
    assert t2.state.step == t2.resume_step == 3
    resumed, _ = t2.run(iter(batches), seed=7)
    assert resumed.step == full.step == 6
    for n, p in full.params.items():
        assert torch.equal(resumed.params[n], p), n
    assert CheckpointManager(ck).latest_step() == 6


def test_trainer_periodic_eval_and_metrics_log(dropout_world, tmp_path):
    """eval_fn fires every eval_steps with the live params, and its record
    reaches the log as the train metrics do (tests/test_train.py's
    test_trainer_periodic_dev_eval); MetricsLogger writes JSONL."""
    cfg, sd, ids, mask, codes = dropout_world
    calls = []
    logger = MetricsLogger(tmp_path / "m.jsonl")
    trainer = Trainer(RiporModel(cfg, device="cpu"),
                      TrainConfig(loss_type="t5seq_aq_encoder_seq2seq"), sd,
                      log_fn=logger, eval_steps=2,
                      eval_fn=lambda p: calls.append(p) or {"dev_mrr_10": .5})
    batch = {"query_ids": ids, "query_mask": mask, "codes": codes}
    trainer.run([batch] * 4, log_every=1)
    assert len(calls) == 2 and calls[0] is trainer.state.params
    recs = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2, 3, 4]
    assert [r["step"] for r in recs if "dev_mrr_10" in r] == [2, 4]


def test_train_state_from_jax_resumes_a_jax_run(world, trajectory, tmp_path):
    """2 JAX steps carried across, then 2 port steps, equal 4 JAX steps."""
    cfg, jm, params, _ = world
    state2 = trajectory["states"][1][0]
    carried = train_state_from_jax(state2, cfg)
    assert carried["step"] == 2 and carried["opt_state"]["count"] == 2
    CheckpointManager(tmp_path / "ck").save(2, carried)
    model = RiporModel(cfg, device="cpu")
    trainer = Trainer(model, trajectory["pcfg"],
                      port_state_dict(params, cfg),
                      checkpoint_dir=tmp_path / "ck")
    assert trainer.resume_step == 2
    state, _ = trainer.run(trajectory["batches"])
    assert state.step == 4
    _assert_params(model, trajectory["states"][3][0].params, cfg)


def test_train_state_from_jax_reads_an_orbax_checkpoint(world, trajectory,
                                                        tmp_path):
    """The JAX Trainer's own checkpoint, read through the Orbax reader
    (tensorstore), carries across as the TrainState object does."""
    pytest.importorskip("tensorstore")
    from ripor_tpu.train.checkpoint import CheckpointManager as JaxManager
    from ripor_tpu_torch.train.checkpoint import read_orbax_tree
    cfg, _, _, _ = world
    state2 = trajectory["states"][1][0]
    JaxManager(tmp_path / "jck").save(2, state2)
    tree = read_orbax_tree(tmp_path / "jck" / "2" / "default")
    got, want = (train_state_from_jax(tree, cfg),
                 train_state_from_jax(state2, cfg))
    assert got["step"] == want["step"] == 2
    assert got["opt_state"]["count"] == 2
    for part in ("params", "mu", "nu"):
        a = got["params"] if part == "params" else got["opt_state"][part]
        b = want["params"] if part == "params" else want["opt_state"][part]
        for n in b:
            assert torch.equal(a[n], b[n]), (part, n)


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"step": step, "params": {"w": torch.ones(2) * step},
                        "opt_state": {"count": step}})
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    assert torch.equal(mgr.restore()["params"]["w"], torch.full((2,), 3.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_resize_codebooks_matches_jax(world):
    cfg, _, params, _ = world
    sd = port_state_dict(params, cfg)
    got = resize_codebooks(sd, new_M=40, new_K=24, seed=3)
    want = jax_resize(dict(params), new_M=40, new_K=24, seed=3)
    assert isinstance(got["codebooks"], torch.Tensor)
    np.testing.assert_array_equal(got["codebooks"].numpy(),
                                  np.asarray(want["codebooks"]))


# ---- regularizers, timing, refusals ----

REGS = ("flops_reg", "l1_reg", "l0_stat", "sparsity_ratio", "ranknet_loss")


@pytest.mark.parametrize("name", REGS)
def test_regularizer_matches_jax(name):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    x[x < 0] = 0.0
    args = (x,) if name != "ranknet_loss" else (x[0], x[1], x[2])
    got = getattr(port_regs, name)(*map(torch.as_tensor, args))
    want = getattr(jax_regs, name)(*map(jnp.asarray, args))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    sched, jsched = (port_regs.RegWeightScheduler(2.0, 10),
                     jax_regs.RegWeightScheduler(2.0, 10))
    for step in (0, 5, 10, 50):
        np.testing.assert_allclose(sched(step), float(jsched(step)),
                                   rtol=1e-6)


def test_step_timer_mfu_needs_a_known_card():
    timer = StepTimer(warmup=1, flops_per_step=1e9)
    for _ in range(3):
        with timer:
            pass
    out = timer.summary()
    assert out["steps"] == 2 and "mfu" not in out
    assert peak_flops("NVIDIA H100 80GB HBM3", torch.float32) == 67e12
    assert peak_flops("NVIDIA H100 80GB HBM3", torch.bfloat16) == 989e12
    assert peak_flops("some other card", torch.float32) is None


def test_training_refusals(world):
    cfg, _, params, _ = world
    sd = port_state_dict(params, cfg)
    for kw, tkw in (({"mesh": object()}, {}), ({}, {"shard_opt_state": True})):
        with pytest.raises(NotImplementedError, match="item 5"):
            Trainer(RiporModel(cfg, device="cpu"), TrainConfig(**tkw), sd,
                    **kw)
