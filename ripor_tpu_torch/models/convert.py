"""Weights for the port's RiporModel: from a flax param tree, or random.

``params_from_jax`` maps the JAX package's flax tree (numpy leaves) onto
this package's state_dict names: ``layer_<i>`` -> ``layers.<i>``, a Dense
``kernel`` [in, out] -> a Linear ``weight`` [out, in], ``shared/embedding``
-> ``shared.weight``; RMSNorm ``scale``, the relpos tables, ``codebooks``,
``output_codebooks`` and ``start_embed`` carry over as they are.

``init_params`` draws a state_dict with the flax initializers' scales
(normal with T5's per-projection std, ones for RMSNorm) from a
``torch.Generator``.

``train_state_from_jax`` carries a JAX training run across: its step,
params and optax AdamW moments become the state the port's Trainer
resumes from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ripor_tpu_torch.models.config import RiporConfig


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Mapping, cfg: RiporConfig) -> Dict[str, torch.Tensor]:
    """flax param tree (nested mappings of numpy arrays) -> state_dict of
    CPU tensors for ``RiporModel(cfg)``."""
    out = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        parts = []
        for p in path:
            if p.startswith("layer_"):
                parts += ["layers", p[len("layer_"):]]
            else:
                parts.append(p)
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            arr = arr.T
        elif parts == ["shared", "embedding"]:
            parts = ["shared", "weight"]
        out[".".join(parts)] = torch.tensor(arr)
    want = _shapes(cfg)
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"flax tree does not fit {cfg}: {diff[:6]}")
    return out


def _shapes(cfg: RiporConfig) -> Dict[str, tuple]:
    from ripor_tpu_torch.models.ripor import RiporModel
    return {k: tuple(v.shape) for k, v in
            RiporModel(cfg, device="meta").state_dict().items()}


def _init_std(name: str, cfg: RiporConfig) -> float:
    """std of the flax initializer behind state_dict entry ``name``;
    0.0 marks RMSNorm scales (ones)."""
    t5 = cfg.t5
    leaf = name.split(".")[-2] if name.endswith(".weight") else None
    if name.endswith(".scale"):
        return 0.0
    if leaf == "q":
        return (t5.d_model * t5.d_kv) ** -0.5
    if leaf in ("k", "v", "wi", "wi_0", "wi_1"):
        return t5.d_model ** -0.5
    if leaf == "o":
        return t5.inner_dim ** -0.5
    if leaf == "wo":
        return t5.d_ff ** -0.5
    return 1.0   # shared, rel_embedding, codebooks, start_embed


def init_params(cfg: RiporConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random state_dict mirroring the flax initializers; tensors on
    ``device`` (the generator's device), floats in ``dtype`` except the
    float32 RMSNorm scales."""
    out = {}
    for name, shape in _shapes(cfg).items():
        std = _init_std(name, cfg)
        if std == 0.0:
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[name] = (torch.randn(shape, generator=generator,
                                     device=device) * std).to(dtype)
    return out


def _as_tree(x) -> Any:
    """Nested mappings of numpy arrays from a pytree of dataclasses (flax
    structs), NamedTuples (optax states), tuples, lists and mappings."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    elif isinstance(x, (tuple, list)):
        x = {str(i): v for i, v in enumerate(x)}
    if isinstance(x, Mapping):
        return {str(k): _as_tree(v) for k, v in x.items()}
    return np.asarray(x)


def _adam_state(tree) -> Mapping:
    """The node of an optax state tree that holds Adam's count, mu, nu."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        for v in tree.values():
            found = _adam_state(v)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, cfg: RiporConfig) -> Dict:
    """The JAX package's TrainState (step, params, the opt_state of
    optax.chain(clip_by_global_norm, adamw)) -> the port's training state
    {"step", "params", "opt_state": {"count", "mu", "nu"}} of CPU tensors,
    the form CheckpointManager.save writes and Trainer resumes from.
    ``state``: the TrainState itself (its arrays are read through numpy)
    or the nested dict of numpy arrays an Orbax reader returns for it
    (train/checkpoint.py: read_orbax_tree)."""
    tree = _as_tree(state)
    adam = _adam_state(tree["opt_state"])
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    return {"step": int(tree["step"]),
            "params": params_from_jax(tree["params"], cfg),
            "opt_state": {"count": int(adam["count"]),
                          "mu": params_from_jax(adam["mu"], cfg),
                          "nu": params_from_jax(adam["nu"], cfg)}}
