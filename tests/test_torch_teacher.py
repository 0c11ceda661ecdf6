"""The port's teacher and baseline models against the JAX package, on the
CPU: BertCrossEncoder, BertDenseEncoder, T5SeqCrossEncoder and
T5DenseEncoder (ripor_tpu_torch.models), their params carried across
(params_from_jax) and drawn (init_params), the four losses bert_bce,
t5seq_bce, margin_mse and kldiv with their gradients, and Trainer steps
of bert_bce and margin_mse against the JAX make_train_step.

Toy geometry: BERT 2 layers, d 48, 4 heads, d_ff 96; the T5 families at
ripor_small (2 + 2 layers, d 64); dropout 0 unless a test says otherwise;
inputs from a numpy seed. Tolerances: float32 forwards rtol 1e-5 /
atol 1e-6; bfloat16 forwards within 3e-2 * max(1, |x|) of the JAX bf16
forward (a few bf16 roundings, 2^-8 each, through two layers); losses
rtol 1e-4 / atol 1e-6 and every parameter's gradient, scaled by its
tensor's largest entry, rtol 1e-4 / atol 2e-6 (tests/test_torch_train.py's
bars), except the BERT key bias, whose gradient is zero but for rounding
(softmax ignores a constant added to a row of scores): on both sides it
stays below 1e-5 of the model's largest gradient. Params after optimizer
steps as tests/test_torch_train_cli.py holds them: in every tensor at
least 99.9 % of the entries within rtol 1e-5 / atol 1e-6 and every entry
within 2 * steps * lr (Adam turns a gradient entry near the f32 noise of
its sum into an update of up to lr either way; so the key bias is held
to the second bar alone).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.models import ripor_small as jax_ripor_small
from ripor_tpu.models.cross_encoder import \
    BertCrossEncoder as JaxBertCrossEncoder
from ripor_tpu.models.cross_encoder import \
    T5SeqCrossEncoder as JaxT5SeqCrossEncoder
from ripor_tpu.models.dense_encoder import \
    BertDenseEncoder as JaxBertDenseEncoder
from ripor_tpu.models.dense_encoder import T5DenseEncoder as JaxT5DenseEncoder
from ripor_tpu.train import TrainConfig as JaxTrainConfig
from ripor_tpu.train import TrainState as JaxTrainState
from ripor_tpu.train import losses as jax_losses
from ripor_tpu.train import make_optimizer as jax_make_optimizer
from ripor_tpu.train import make_train_step as jax_make_train_step
from ripor_tpu_torch.models import (BertConfig, BertCrossEncoder,
                                    BertDenseEncoder, T5DenseEncoder,
                                    T5SeqCrossEncoder, init_params,
                                    params_from_jax, ripor_small)
from ripor_tpu_torch.models.cross_encoder import bce_loss
from ripor_tpu_torch.train import LOSS_FNS, TrainConfig, Trainer

B, L, V = 4, 12, 120
BERT = dict(vocab_size=V, d_model=48, num_layers=2, num_heads=4, d_ff=96,
            max_position=32)
M, K = 6, 16
FAMILIES = ("bert_cross", "bert_dense", "t5seq_cross", "t5_dense")


def _ids(rng, n=B, length=L):
    ids = rng.integers(5, V, (n, length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -4:] = 0
    mask[2, -7:] = 0
    return ids, mask


def _models(family, dropout=0.0):
    """(JAX module, a function building the port's module) of a family."""
    if family == "bert_cross":
        return (JaxBertCrossEncoder(dropout=dropout, **BERT),
                lambda **kw: BertCrossEncoder(dropout=dropout, **BERT, **kw))
    if family == "bert_dense":
        return (JaxBertDenseEncoder(dropout=dropout, **BERT),
                lambda **kw: BertDenseEncoder(dropout=dropout, **BERT, **kw))
    jcfg = jax_ripor_small(M=M, K=K)
    pcfg = ripor_small(M=M, K=K)
    if family == "t5seq_cross":
        return JaxT5SeqCrossEncoder(jcfg), lambda **kw: T5SeqCrossEncoder(
            pcfg, **kw)
    return JaxT5DenseEncoder(jcfg.t5), lambda **kw: T5DenseEncoder(
        pcfg.t5, **kw)


def _inputs(family, rng):
    ids, mask = _ids(rng)
    if family == "bert_cross":
        types = np.zeros_like(ids)
        types[:, 5:] = mask[:, 5:]
        return ids, mask, types
    if family == "t5seq_cross":
        return ids, mask, rng.integers(0, K, (B, M)).astype(np.int32)
    return ids, mask


@pytest.fixture(scope="module")
def family_params():
    """flax params of each family, drawn by the JAX module's init."""
    out = {}
    rng = np.random.default_rng(0)
    for i, fam in enumerate(FAMILIES):
        jm, _ = _models(fam)
        args = [jnp.asarray(a) for a in _inputs(fam, rng)]
        out[fam] = jax.tree.map(np.asarray, jax.jit(jm.init)(
            {"params": jax.random.PRNGKey(i)}, *args)["params"])
    return out


def _port(family, params, dtype=torch.float32):
    _, make = _models(family)
    model = make(dtype=dtype, device="cpu")
    model.load_state_dict(params_from_jax(params, make(device="meta")))
    return model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family_params, family, dtype):
    params = family_params[family]
    jm, _ = _models(family)
    jm = jm.clone(dtype=getattr(jnp, dtype))
    args = _inputs(family, np.random.default_rng(1))
    want = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, *map(jnp.asarray, args)), np.float32)
    model = _port(family, params, getattr(torch, dtype))
    with torch.no_grad():
        got = model(*map(torch.as_tensor, args)).float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(got - want)
                      <= 3e-2 * np.maximum(1.0, np.abs(want))), \
            np.abs(got - want).max()


def test_bert_config_geometries():
    assert BertConfig.minilm_l6() == BertConfig(
        vocab_size=30522, d_model=384, num_layers=6, num_heads=12,
        d_ff=1536, max_position=512)
    base = BertConfig.bert_base()
    assert (base.d_model, base.num_layers, base.num_heads, base.d_ff) == (
        768, 12, 12, 3072)
    assert BertCrossEncoder(device="meta").cfg.vocab_size == 32128
    assert BertDenseEncoder(device="meta").cfg.d_model == 768


@pytest.mark.parametrize("family", FAMILIES)
def test_params_from_jax_fit_and_refuse_a_misfit(family_params, family):
    _, make = _models(family)
    sd = params_from_jax(family_params[family], make(device="meta"))
    assert set(sd) == set(make(device="meta").state_dict())
    other = {"bert_cross": "bert_dense", "bert_dense": "bert_cross",
             "t5seq_cross": "t5_dense", "t5_dense": "t5seq_cross"}[family]
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(family_params[other], make(device="meta"))


@pytest.mark.parametrize("family", FAMILIES)
def test_init_params_follow_the_flax_initializers(family_params, family):
    """Every entry drawn: the names, shapes and dtypes of the model's
    state_dict, and each entry's spread and range as the flax initializer
    behind the same entry of the JAX init gives them."""
    _, make = _models(family)
    model = make(device="cpu")
    sd = init_params(model, torch.Generator().manual_seed(0))
    flax = params_from_jax(family_params[family], make(device="meta"))
    assert {k: (v.shape, v.dtype) for k, v in sd.items()} == {
        k: (v.shape, v.dtype) for k, v in model.state_dict().items()}
    model.load_state_dict(sd)
    for name, got in sd.items():
        want = flax[name]
        if want.numel() < 500:        # too few draws for a spread
            if (want == want.flatten()[0]).all():      # ones or zeros
                assert torch.equal(got, want), name
            continue
        np.testing.assert_allclose(float(got.std()), float(want.std()),
                                   rtol=0.1, err_msg=name)
        np.testing.assert_allclose(float(got.abs().max() / got.std()),
                                   float(want.abs().max() / want.std()),
                                   rtol=0.35, err_msg=name)
    again = init_params(model, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], v) for k, v in sd.items())


# ---- the four losses ----

def _loss_setup(name, rng):
    """(family, flax params, batch) of a teacher or baseline loss."""
    if name == "bert_bce":
        ids, mask, types = _inputs("bert_cross", rng)
        return "bert_cross", {"input_ids": ids, "attention_mask": mask,
                              "token_type_ids": types,
                              "labels": np.array([1, 0, 1, 0], np.float32)}
    if name == "t5seq_bce":
        ids, mask, codes = _inputs("t5seq_cross", rng)
        return "t5seq_cross", {"query_ids": ids, "query_mask": mask,
                               "codes": codes,
                               "labels": np.array([0, 1, 1, 0], np.float32)}
    batch = {}
    for side in ("query", "pos_doc", "neg_doc"):
        batch[f"{side}_ids"], batch[f"{side}_mask"] = _ids(rng)
    for side in ("pos", "neg"):
        batch[f"teacher_{side}_score"] = (rng.standard_normal(B) * 3
                                          ).astype(np.float32)
    return "t5_dense", batch


LOSSES = ("bert_bce", "t5seq_bce", "margin_mse", "kldiv")


@pytest.mark.parametrize("name", LOSSES)
def test_loss_and_grads_match_jax(family_params, name):
    family, batch = _loss_setup(name, np.random.default_rng(2))
    params = family_params[family]
    jm, make = _models(family)

    def jax_total(p, batch):
        d = jax_losses.LOSS_FNS[name](jm, p, batch, train=False)
        return sum(d.values()), d

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port(family, params)
    model.requires_grad_(True)
    got = LOSS_FNS[name](model, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, train=False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].ndim == 0
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   atol=1e-6)
    sum(got.values()).backward()
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgrads),
                             make(device="meta"))
    top = max(float(g.abs().max()) for g in jgrads.values())
    for n, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if n.endswith("attn.k.bias"):
            # zero but for rounding (softmax ignores a constant added to a
            # row of scores) on both sides
            assert float(g.abs().max()) <= 1e-5 * top, n
            assert float(jgrads[n].abs().max()) <= 1e-5 * top, n
            continue
        scale = max(float(jgrads[n].abs().max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale,
                                   jgrads[n].numpy() / scale, rtol=1e-4,
                                   atol=2e-6, err_msg=n)


def test_bce_loss_matches_jax():
    from ripor_tpu.models.cross_encoder import bce_loss as jax_bce
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(64) * 30).astype(np.float32)
    labels = rng.integers(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        bce_loss(torch.as_tensor(logits), torch.as_tensor(labels)).item(),
        float(jax_bce(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_dropout_follows_the_generator(family_params, name):
    """With dropout on, a loss is a function of its generator's state: the
    same state gives the same loss, another state or train=False another."""
    family, batch = _loss_setup(name, np.random.default_rng(4))
    _, make = _models(family, dropout=0.3)
    if family.startswith("t5"):
        import dataclasses
        cfg = ripor_small(M=M, K=K)
        cfg = dataclasses.replace(cfg, t5=dataclasses.replace(
            cfg.t5, dropout_rate=0.3))
        model = (T5SeqCrossEncoder(cfg, device="cpu")
                 if family == "t5seq_cross"
                 else T5DenseEncoder(cfg.t5, device="cpu"))
    else:
        model = make(device="cpu")
    model.load_state_dict(params_from_jax(family_params[family],
                                          make(device="meta")))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    def loss(seed, train=True):
        g = torch.Generator().manual_seed(seed)
        return float(LOSS_FNS[name](model, tb, train, g)[
            "cls" if name.endswith("bce") else "rank"])
    assert loss(0) == loss(0)
    assert loss(0) != loss(1)
    assert loss(0) != loss(0, train=False)


# ---- Trainer steps against the JAX step ----

@pytest.mark.parametrize("name", ["bert_bce", "margin_mse"])
def test_trainer_steps_match_jax(family_params, name):
    rng = np.random.default_rng(5)
    family, _ = _loss_setup(name, rng)
    batches = [_loss_setup(name, rng)[1] for _ in range(2)]
    params = family_params[family]
    jm, make = _models(family)
    base = dict(loss_type=name, learning_rate=1e-3, warmup_steps=1,
                total_steps=5, grad_clip=0.5, weight_decay=0.01)
    jcfg = JaxTrainConfig(**base)
    tx = jax_make_optimizer(jcfg)
    step = jax.jit(jax_make_train_step(jm, jcfg, tx))
    state = JaxTrainState.create(params, tx)
    model = make(device="cpu")
    trainer = Trainer(model, TrainConfig(**base),
                      params_from_jax(params, make(device="meta")))
    for i, b in enumerate(batches):
        state, jmetrics = step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()},
                               jax.random.fold_in(jax.random.PRNGKey(0), i))
        pstate, metrics = trainer.run(batches[:i + 1], seed=0)
        assert pstate.step == i + 1
        for k, v in jax.tree.map(np.asarray, jmetrics).items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        want = params_from_jax(jax.tree.map(np.asarray, state.params),
                               make(device="meta"))
        for n, p in model.state_dict().items():
            g, w = p.numpy(), want[n].numpy()
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2 * (i + 1) * base["learning_rate"],
                                       err_msg=n)
            if n.endswith("attn.k.bias"):
                continue        # a gradient of rounding noise, see above
            loose = ~np.isclose(g, w, rtol=1e-5, atol=1e-6)
            assert loose.mean() <= 1e-3, (n, int(loose.sum()), w.size)
