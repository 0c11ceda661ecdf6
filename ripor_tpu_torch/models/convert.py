"""Weights for the port's models: from a flax param tree, or random.

``params_from_jax`` maps the JAX package's flax tree (numpy leaves) onto
this package's state_dict names, for every ported family: RiporModel,
BertCrossEncoder, BertDenseEncoder, T5SeqCrossEncoder and T5DenseEncoder.
The rules are the same for all: ``layer_<i>`` -> ``layers.<i>``, a Dense
``kernel`` [in, out] -> a Linear ``weight`` [out, in], an Embed
``embedding`` -> an Embedding ``weight``; norm ``scale``/``bias``, Dense
``bias``, the relpos tables, ``codebooks``, ``output_codebooks`` and
``start_embed`` carry over as they are (the T5 head's unnamed
``Dense_0``/``Dense_1`` keep their names). The result must fit the target
model's state_dict, name for name and shape for shape.

``init_params`` draws a state_dict with the flax initializers'
distributions from a ``torch.Generator``: T5's per-projection normal
stds, ones for the norms' scales, and for the BERT families and the T5
classification head flax's defaults (lecun-normal Dense kernels — a
normal truncated at two stds — zero biases, normal(1/sqrt(d)) Embed
tables, zero LayerNorm biases). The draws differ from flax's.

``train_state_from_jax`` carries a JAX training run across: its step,
params and optax AdamW moments become the state the port's Trainer
resumes from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ripor_tpu_torch.models.config import RiporConfig


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """flax param tree (nested mappings of numpy arrays) -> state_dict of
    CPU tensors for ``cfg``: a RiporConfig (for ``RiporModel(cfg)``) or a
    model of any ported family (e.g. ``BertCrossEncoder(...)``, on any
    device, ``"meta"`` included)."""
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
        elif parts[-1] == "embedding":
            parts[-1] = "weight"
        out[".".join(parts)] = torch.tensor(arr)
    want = {k: shape for k, (shape, _) in _entries(cfg).items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        target = type(cfg).__name__ if isinstance(cfg, nn.Module) else cfg
        raise ValueError(f"flax tree does not fit {target}: {diff[:6]}")
    return out


def _entries(cfg) -> Dict[str, tuple]:
    """name -> (shape, dtype) of the state_dict of ``cfg`` (a RiporConfig,
    for RiporModel(cfg) in float32, or a model)."""
    if not isinstance(cfg, nn.Module):
        from ripor_tpu_torch.models.ripor import RiporModel
        cfg = RiporModel(cfg, device="meta")
    return {k: (tuple(v.shape), v.dtype) for k, v in cfg.state_dict().items()}


def _t5_std(name: str, t5) -> float:
    """std of the T5 flax initializer behind state_dict entry ``name``;
    0.0 marks RMSNorm scales (ones)."""
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


# flax's lecun_normal: a normal truncated to [-2, 2] stds, rescaled so the
# truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator, device) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], by the inverse CDF of a
    uniform draw (jax.random.truncated_normal's method)."""
    lo, hi = (torch.special.ndtr(torch.tensor(v, dtype=torch.float64))
              for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float64)
    return torch.special.ndtri(lo + (hi - lo) * u).float()


def _draw(name: str, shape, target, generator, device) -> torch.Tensor:
    """One entry of ``target``'s state_dict, drawn as its flax initializer
    draws it (float32)."""
    from ripor_tpu_torch.models.cross_encoder import T5SeqCrossEncoder
    from ripor_tpu_torch.models.dense_encoder import T5DenseEncoder
    from ripor_tpu_torch.models.ripor import RiporModel
    t5 = None
    if not isinstance(target, nn.Module):
        t5 = target.t5
    elif isinstance(target, RiporModel):
        t5 = target.cfg.t5
    elif isinstance(target, T5DenseEncoder):
        t5 = target.cfg
    elif isinstance(target, T5SeqCrossEncoder) and name.startswith("base."):
        t5 = target.cfg.t5
    if t5 is not None:
        std = _t5_std(name, t5)
        if std == 0.0:
            return torch.ones(shape, device=device)
        return torch.randn(shape, generator=generator, device=device) * std
    # BERT families and the T5 classification head: flax's defaults
    leaf = name.split(".")[-2] if "." in name else ""
    if name.endswith(".scale"):
        return torch.ones(shape, device=device)
    if name.endswith(".bias"):
        return torch.zeros(shape, device=device)
    if leaf in ("word", "position", "type"):          # nn.Embed tables
        return (torch.randn(shape, generator=generator, device=device)
                * shape[1] ** -0.5)
    return (_truncated_normal(shape, generator, device)          # Dense
            * (shape[1] ** -0.5 / _TRUNC_STD))


def init_params(cfg, generator: torch.Generator, device=None,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Random state_dict mirroring the flax initializers, tensors on
    ``device`` (the generator's device). ``cfg``: a RiporConfig — floats
    in ``dtype``, except the float32 RMSNorm scales — or a model of any
    ported family, whose entries' dtypes the draws take."""
    out = {}
    for name, (shape, entry_dtype) in _entries(cfg).items():
        value = _draw(name, shape, cfg, generator, device)
        if isinstance(cfg, nn.Module):
            out[name] = value.to(entry_dtype)
        else:
            out[name] = (value if name.endswith(".scale")
                         else value.to(dtype))
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
