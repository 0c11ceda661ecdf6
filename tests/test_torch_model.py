"""The port's RiporModel (f32, CPU) against the JAX package's RiporModel on
the same flax params: the same f32 math, so 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.models.layers import relative_position_bucket as jax_bucket
from ripor_tpu_torch.models import init_params, ripor_small
from ripor_tpu_torch.models.layers import relative_position_bucket
from ripor_tpu_torch.models.ripor import RiporModel
from torch_parity import port_model, setup

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    cfg, params, ids, mask, _ = setup(M=5, K=8, batch=3)
    mask = mask.copy()
    mask[1, 7:] = 0                           # a padded query
    rng = np.random.default_rng(1)
    codes = rng.integers(0, cfg.K, (3, cfg.M)).astype(np.int32)
    return (cfg, params, port_model(params, cfg), JaxRiporModel(cfg),
            ids, mask, codes)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_encode_matches_jax(models):
    cfg, params, pm, jm, ids, mask, _ = models
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                    method=JaxRiporModel.encode)
    got = pm.encode(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method", ["forward_logits", "rerank_score"])
def test_teacher_forced_matches_jax(models, method):
    cfg, params, pm, jm, ids, mask, codes = models
    want = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                    jnp.asarray(codes),
                    method=getattr(JaxRiporModel, method))
    got = getattr(pm, method)(_t(ids), _t(mask), _t(codes).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_matches_jax(bidirectional):
    rel = np.arange(-300, 301, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional))
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional)
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_loads_with_flax_scales():
    cfg = ripor_small(M=4, K=8)
    sd = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = RiporModel(cfg)
    model.load_state_dict(sd)
    t5 = cfg.t5
    q = sd["decoder.layers.0.self_attn.q.weight"]
    assert q.shape == (t5.inner_dim, t5.d_model)
    assert abs(q.std().item() - (t5.d_model * t5.d_kv) ** -0.5) < 0.2 * (
        t5.d_model * t5.d_kv) ** -0.5
    assert torch.equal(sd["encoder.final_norm.scale"],
                       torch.ones(t5.d_model))
    assert sd["encoder.final_norm.scale"].dtype == torch.float32
