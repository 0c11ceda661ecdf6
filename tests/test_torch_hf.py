"""The port's HF import (ripor_tpu_torch.models.import_hf) against
``transformers``' own models, randomly initialised from a local config
(nothing is downloaded), and against the JAX package's import: T5 v1.0
and v1.1 (gated) into RiporModel and T5DenseEncoder, BERT into
BertCrossEncoder (BertForSequenceClassification, num_labels=1) and
BertDenseEncoder (BertModel), and the checkpoint file readers.

Geometry and bars of tests/test_hf_parity.py: outputs within rtol 2e-4 /
atol 2e-5 of transformers' (padded positions, which HF still computes,
are left out); the port's state_dict equal to params_from_jax of the JAX
package's import of the same state dict.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from ripor_tpu.models import RiporConfig as JaxRiporConfig  # noqa: E402
from ripor_tpu.models import RiporModel as JaxRiporModel  # noqa: E402
from ripor_tpu.models import T5Config as JaxT5Config  # noqa: E402
from ripor_tpu.models.cross_encoder import \
    BertCrossEncoder as JaxBertCrossEncoder  # noqa: E402
from ripor_tpu.models.import_hf import \
    hf_bert_to_params as jax_hf_bert  # noqa: E402
from ripor_tpu.models.import_hf import \
    hf_t5_to_params as jax_hf_t5  # noqa: E402
from ripor_tpu_torch.models import (BertCrossEncoder,  # noqa: E402
                                    BertDenseEncoder, RiporConfig,
                                    RiporModel, T5Config, T5DenseEncoder,
                                    hf_bert_to_params, hf_t5_to_params,
                                    init_params, load_hf_t5_file,
                                    params_from_jax)

T5_GEO = dict(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=3,
              num_decoder_layers=3, num_heads=4, dropout_rate=0.0)
BERT_GEO = dict(vocab_size=200, d_model=48, num_layers=3, num_heads=4,
                d_ff=96, max_position=64, dropout=0.0)
BARS = dict(rtol=2e-4, atol=2e-5)


def _hf_t5(gated=False, seed=0):
    cfg = transformers.T5Config(
        vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=3,
        num_decoder_layers=3, num_heads=4, relative_attention_num_buckets=32,
        relative_attention_max_distance=128, dropout_rate=0.0,
        feed_forward_proj="gated-gelu" if gated else "relu",
        is_encoder_decoder=True, decoder_start_token_id=0, pad_token_id=0,
        eos_token_id=1)
    torch.manual_seed(seed)
    return transformers.T5Model(cfg).eval()


def _hf_bert(cls, seed=0, **kw):
    cfg = transformers.BertConfig(
        vocab_size=200, hidden_size=48, num_hidden_layers=3,
        num_attention_heads=4, intermediate_size=96,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu", pad_token_id=0, **kw)
    torch.manual_seed(seed)
    return cls(cfg).eval()


def _ripor(gated=False):
    t5 = T5Config(**T5_GEO, feed_forward_proj="gated-gelu" if gated
                  else "relu")
    return RiporConfig(t5=t5, M=6, K=16)


def _port_ripor(hf, gated=False):
    cfg = _ripor(gated)
    tmpl = init_params(cfg, torch.Generator().manual_seed(0))
    sd = hf_t5_to_params(hf.state_dict(), tmpl)
    model = RiporModel(cfg, device="cpu")
    model.load_state_dict(sd)
    return cfg, tmpl, sd, model


def _ids(rng, n, length, low=2, high=256):
    ids = rng.integers(low, high, (n, length))
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    return ids, mask


@pytest.mark.parametrize("gated", [False, True])
def test_t5_encoder_matches_transformers(gated):
    hf = _hf_t5(gated)
    _, _, _, model = _port_ripor(hf, gated)
    ids, mask = _ids(np.random.default_rng(0), 2, 12)
    with torch.no_grad():
        want = hf.encoder(input_ids=torch.tensor(ids),
                          attention_mask=torch.tensor(mask)
                          ).last_hidden_state.numpy()
        got = model.encode(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got[0], want[0], **BARS)
    np.testing.assert_allclose(got[1, :8], want[1, :8], **BARS)


def test_t5_decoder_matches_transformers():
    """The full encoder-decoder: HF fed the per-position embeddings the
    codebook head produces."""
    hf = _hf_t5()
    cfg, _, _, model = _port_ripor(hf)
    rng = np.random.default_rng(1)
    ids = rng.integers(2, 256, (2, 12))
    mask = np.ones_like(ids)
    codes = torch.tensor(rng.integers(0, cfg.K, (2, cfg.M)))
    with torch.no_grad():
        dec_in = model.decoder_inputs_from_codes(codes)
        enc = hf.encoder(input_ids=torch.tensor(ids),
                         attention_mask=torch.tensor(mask)).last_hidden_state
        want = hf.decoder(inputs_embeds=dec_in, encoder_hidden_states=enc,
                          encoder_attention_mask=torch.tensor(mask)
                          ).last_hidden_state.numpy()
        got = model(torch.tensor(ids), torch.tensor(mask), codes).numpy()
    np.testing.assert_allclose(got, want, **BARS)


def test_t5_dense_encoder_takes_the_t5_import():
    """T5DenseEncoder's tree has RiporModel's T5 names: the import fills
    it, and its rep is HF's decoder hidden at position 0 from the start
    embedding."""
    hf = _hf_t5(seed=3)
    model = T5DenseEncoder(T5Config(**T5_GEO), device="cpu")
    tmpl = init_params(model, torch.Generator().manual_seed(0))
    model.load_state_dict(hf_t5_to_params(hf.state_dict(), tmpl))
    ids, mask = _ids(np.random.default_rng(2), 3, 12)
    with torch.no_grad():
        enc = hf.encoder(input_ids=torch.tensor(ids),
                         attention_mask=torch.tensor(mask)).last_hidden_state
        start = model.start_embed[None, None].expand(3, 1, -1)
        want = hf.decoder(inputs_embeds=start, encoder_hidden_states=enc,
                          encoder_attention_mask=torch.tensor(mask)
                          ).last_hidden_state[:, 0].numpy()
        got = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, **BARS)


@pytest.mark.parametrize("gated", [False, True])
def test_t5_import_equals_the_jax_import(gated):
    hf = _hf_t5(gated, seed=4)
    cfg, tmpl, sd, _ = _port_ripor(hf, gated)
    jcfg = JaxRiporConfig(t5=JaxT5Config(
        **T5_GEO, feed_forward_proj="gated-gelu" if gated else "relu"),
        M=6, K=16)
    ids = jnp.ones((1, 6), jnp.int32)
    jparams = JaxRiporModel(jcfg).init(
        {"params": jax.random.PRNGKey(0)}, ids, ids,
        jnp.zeros((1, 6), jnp.int32))["params"]
    want = params_from_jax(jax_hf_t5(hf.state_dict(), jax.tree.map(
        np.asarray, jparams)), cfg)
    for n in ("codebooks", "start_embed"):      # no HF counterpart
        assert torch.equal(sd[n], tmpl[n])
        want[n] = sd[n]
    assert set(sd) == set(want)
    for n in want:
        assert sd[n].dtype == tmpl[n].dtype, n
        assert torch.equal(sd[n], want[n]), n


def test_bert_cross_encoder_matches_transformers():
    hf = _hf_bert(transformers.BertForSequenceClassification, num_labels=1)
    model = BertCrossEncoder(**BERT_GEO, device="cpu")
    model.load_state_dict(hf_bert_to_params(
        hf.state_dict(), init_params(model, torch.Generator().manual_seed(0))))
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 200, (3, 12))
    mask = np.ones_like(ids)
    mask[2, 9:] = 0
    types = np.zeros_like(ids)
    types[:, 6:] = 1
    args = [torch.tensor(a) for a in (ids, mask, types)]
    with torch.no_grad():
        want = hf(input_ids=args[0], attention_mask=args[1],
                  token_type_ids=args[2]).logits[:, 0].numpy()
        got = model(*args).numpy()
    np.testing.assert_allclose(got, want, **BARS)


def test_bert_dense_encoder_matches_transformers():
    hf = _hf_bert(transformers.BertModel, seed=1)
    model = BertDenseEncoder(**BERT_GEO, device="cpu")
    tmpl = init_params(model, torch.Generator().manual_seed(0))
    sd = hf_bert_to_params(hf.state_dict(), tmpl)
    model.load_state_dict(sd)
    ids, mask = _ids(np.random.default_rng(1), 2, 10, low=5, high=200)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(
            mask)).last_hidden_state[:, 0].numpy()
        got = model(torch.tensor(ids), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, **BARS)


@pytest.mark.parametrize("prefixed", [True, False])
def test_bert_import_equals_the_jax_import(prefixed):
    """Keys with the ``bert.`` prefix (BertForSequenceClassification) and
    without (a bare BertModel's keys beside an unprefixed classifier)."""
    hf = _hf_bert(transformers.BertForSequenceClassification, seed=2,
                  num_labels=1)
    state = hf.state_dict()
    if not prefixed:
        state = {k.removeprefix("bert."): v for k, v in state.items()}
    model = BertCrossEncoder(**BERT_GEO, device="cpu")
    tmpl = init_params(model, torch.Generator().manual_seed(0))
    sd = hf_bert_to_params(state, tmpl)
    jm = JaxBertCrossEncoder(**BERT_GEO)
    ids = jnp.ones((1, 8), jnp.int32)
    jparams = jm.init({"params": jax.random.PRNGKey(0)}, ids, ids)["params"]
    want = params_from_jax(jax_hf_bert(state, jax.tree.map(np.asarray,
                                                           jparams)), model)
    assert set(sd) == set(want)
    for n in want:
        assert torch.equal(sd[n], want[n]), n
    assert not torch.equal(sd["pooler.weight"], tmpl["pooler.weight"])
    assert torch.equal(sd["classifier.weight"],
                       state["classifier.weight"].float())


def test_import_checks_shapes():
    hf = _hf_bert(transformers.BertModel)
    model = BertCrossEncoder(**dict(BERT_GEO, d_ff=128), device="meta")
    with pytest.raises(ValueError, match="ffn_wi"):
        hf_bert_to_params(hf.state_dict(), dict(model.state_dict()))


def test_load_hf_t5_file_reads_bin_and_safetensors(tmp_path):
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file
    hf = _hf_t5(seed=5)
    state = {k: v.contiguous() for k, v in hf.state_dict().items()}
    torch.save(state, tmp_path / "pytorch_model.bin")
    save_file({k: v.clone() for k, v in state.items()},
              str(tmp_path / "model.safetensors"))
    cfg = _ripor()
    tmpl = init_params(cfg, torch.Generator().manual_seed(0))
    want = hf_t5_to_params(state, tmpl)
    for name in ("pytorch_model.bin", "model.safetensors"):
        got = hf_t5_to_params(load_hf_t5_file(str(tmp_path / name)), tmpl)
        assert all(torch.equal(got[k], want[k]) for k in want), name
