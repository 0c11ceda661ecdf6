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


def setup(M=6, K=8, n_docs=40, batch=2, seed=0, jax_init=True):
    """-> (cfg, flax params, ids, mask, doc_codes), as in
    tests/test_beam.py::setup (ids/mask/doc_codes are numpy). With
    ``jax_init=False`` the params come from seeded_params (no JAX
    compile; other values)."""
    cfg = ripor_small(M=M, K=K)
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, (batch, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    if not jax_init:
        params = seeded_params(cfg, seed)
    else:
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


def flax_tree(state_dict):
    """The flax param tree (numpy leaves) of a port RiporModel state_dict:
    the inverse of params_from_jax (``layers.<i>`` -> ``layer_<i>``, a
    Linear ``weight`` [out, in] -> a Dense ``kernel`` [in, out], the token
    Embedding ``weight`` -> ``embedding``)."""
    tree = {}
    for name, v in state_dict.items():
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == "layers":
                path.append(f"layer_{parts[i + 1]}")
                i += 2
                continue
            path.append(parts[i])
            i += 1
        arr = v.detach().cpu().numpy()
        if path[-1] == "weight":
            if path[:-1] == ["shared"]:
                path[-1] = "embedding"
            else:
                path[-1] = "kernel"
                arr = arr.T
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def seeded_params(cfg, seed):
    """Flax params for ``cfg`` drawn from a seed without a JAX init (no
    compile): the port's init_params, as a flax tree."""
    from ripor_tpu_torch.models import init_params
    return flax_tree(init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu"))


def port_name_and_flip(path):
    """JAX tree path -> (port state_dict name, whether the port's tensor is
    the transpose): models/convert.py's mapping."""
    parts = []
    for p in path:
        k = p.key
        parts += ["layers", k[len("layer_"):]] if k.startswith("layer_") \
            else [k]
    flip = parts[-1] == "kernel"
    if parts[-1] in ("kernel", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts), flip
