"""Shared set-up for the port's parity tests (tests/test_torch_*.py):
one toy model, query batch and corpus made from a numpy seed, its flax
params, and the same params loaded into the port's RiporModel."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ripor_tpu.models import RiporModel as JaxRiporModel
from ripor_tpu.models import ripor_small
from ripor_tpu_torch.models import RiporModel, params_from_jax


def setup(M=6, K=8, n_docs=40, batch=2, seed=0):
    """-> (cfg, flax params, ids, mask, doc_codes), as in
    tests/test_beam.py::setup (ids/mask/doc_codes are numpy)."""
    cfg = ripor_small(M=M, K=K)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, (batch, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    params = JaxRiporModel(cfg).init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(ids),
        jnp.asarray(mask), jnp.zeros((batch, M), jnp.int32))["params"]
    doc_codes = rng.integers(0, K, (n_docs, M))
    return cfg, params, ids, mask, doc_codes


def port_state_dict(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), cfg)


def port_model(params, cfg, dtype=torch.float32):
    """The same weights in the port's model, on the CPU."""
    model = RiporModel(cfg, dtype=dtype, device="cpu")
    model.load_state_dict(port_state_dict(params, cfg))
    return model
