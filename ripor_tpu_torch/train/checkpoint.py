"""Model checkpoints in PyTorch's idiom, and a reader of the JAX package's.

Counterpart of ripor_tpu/train/checkpoint.py. A checkpoint directory
(``save_params``/``load_params``) holds

  params.pt      a state_dict of CPU tensors (``torch.save``) of any
                 family: RiporModel, or a teacher or baseline model
  config.json    the RiporConfig (``RiporConfig.to_json``), where the
                 model has one

``CheckpointManager`` keeps a training run's states, one directory a step
(``<step>/state.pt``: step, params and the optimizer state, written to a
temporary file and renamed into place, so a run cut mid-save leaves the
previous checkpoint the latest), pruned to ``max_to_keep``.

``load_params`` also reads a checkpoint the JAX package saved: an Orbax
``StandardCheckpointer`` tree under ``params/`` (OCDBT key-value store,
zarr arrays). It reads each leaf through ``tensorstore``, imported only
there, and maps the tree with ``params_from_jax`` onto the model it is
for. ``params.pt`` is read
first when both exist. ``resize_codebooks`` changes the DocID geometry
between phases.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.convert import params_from_jax

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """Training states under ``directory/<step>/state.pt``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self):
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / STATE_FILE).exists())

    def save(self, step: int, state: Any,
             config: Optional[RiporConfig] = None) -> None:
        """``state``: a TrainState (train/trainer.py) or a mapping with its
        fields (step, params, opt_state); tensors are saved on the CPU."""
        tree = state if isinstance(state, Mapping) else vars(state)
        d = self.directory / str(step)
        d.mkdir(exist_ok=True)
        tmp = d / (STATE_FILE + ".tmp")
        torch.save(_cpu(dict(tree)), tmp)
        os.replace(tmp, d / STATE_FILE)
        if config is not None:
            (self.directory / "config.json").write_text(config.to_json())
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict:
        """The saved state of ``step`` (default: the latest) as a dict of
        CPU tensors: {"step", "params", "opt_state"}."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.directory / str(step) / STATE_FILE,
                          map_location="cpu", weights_only=True)

    def load_config(self) -> RiporConfig:
        return RiporConfig.from_json(
            (self.directory / "config.json").read_text())


def has_params(path: str | Path) -> bool:
    """Whether ``path`` holds a checkpoint that load_params reads:
    ``params.pt``, or the JAX package's Orbax ``params/``."""
    path = Path(path)
    return (path / PARAMS_FILE).exists() or (path / "params").exists()


def save_params(path: str | Path, params: Mapping[str, torch.Tensor],
                config: Optional[RiporConfig] = None) -> None:
    """Write ``path/params.pt`` (the state_dict, moved to the CPU) and, with
    a config, ``path/config.json``."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               path / PARAMS_FILE)
    if config is not None:
        (path / "config.json").write_text(config.to_json())


def load_params(path: str | Path, cfg: Optional[RiporConfig] = None,
                model: Optional[nn.Module] = None
                ) -> Dict[str, torch.Tensor]:
    """State dict from a checkpoint directory: ``params.pt`` (of any
    family) when it exists, else the JAX package's Orbax ``params/``,
    converted for ``model`` when one is given (a model of any ported
    family, e.g. a BertCrossEncoder teacher; the tree must fit it), else
    for ``RiporModel(cfg)`` (``cfg`` defaults to ``path/config.json``)."""
    path = Path(path).absolute()
    if (path / PARAMS_FILE).exists():
        return torch.load(path / PARAMS_FILE, map_location="cpu",
                          weights_only=True)
    if not (path / "params").is_dir():
        raise FileNotFoundError(f"no {PARAMS_FILE} and no Orbax params/ "
                                f"directory in {path}")
    if model is None and cfg is None:
        cfg = RiporConfig.load(path / "config.json")
    return params_from_jax(read_orbax_tree(path / "params"),
                           model if model is not None else cfg)


def read_orbax_tree(directory: str | Path) -> Dict:
    """The nested dict of numpy arrays an Orbax StandardCheckpointer saved
    in ``directory``. Leaves saved in bfloat16 come back as float32 (a
    widening, so exact). Needs ``tensorstore``."""
    directory = Path(directory).absolute()
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            f"{directory} is an Orbax checkpoint of the JAX package, and "
            "reading it needs the tensorstore package, which this "
            "environment lacks. On a machine that has tensorstore, "
            "save_params(dir, load_params(dir), cfg) "
            "(ripor_tpu_torch.train) writes dir/params.pt, which "
            "load_params reads without it.") from e
    meta = json.loads((directory / "_METADATA").read_text())
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{directory}: only OCDBT Orbax checkpoints are "
                         "read (the StandardCheckpointer default)")
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        if entry.get("value_metadata", {}).get("skip_deserialize"):
            continue            # an empty node (optax's EmptyState): no array
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        spec = {"driver": driver,
                "kvstore": {"driver": "ocdbt",
                            "base": f"file://{directory}/",
                            "path": ".".join(keys)}}
        arr = ts.open(spec).result().read().result()
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(arr)
    return tree


def resize_codebooks(params: Mapping, new_M: int, new_K: int,
                     init_scale: float = 1.0, seed: int = 0) -> Dict:
    """Phase-transition transform: change the DocID geometry between phases
    (the reference rebuilds nn.Embedding lists and saves a
    'no_share_checkpoint'; change_customized_embed_layer.py:59-84).
    Existing rows are kept where they fit; new rows are N(0, init_scale)
    from numpy's generator at ``seed``, the JAX package's draws. Tensors
    come back as tensors, arrays as arrays."""
    rng = np.random.default_rng(seed)
    out = dict(params)
    for name in ("codebooks", "output_codebooks"):
        if name not in params:
            continue
        old = np.asarray(params[name])
        M, K, d = old.shape
        new = (init_scale * rng.standard_normal((new_M, new_K, d))
               ).astype(old.dtype)
        new[:min(M, new_M), :min(K, new_K)] = old[:min(M, new_M),
                                                  :min(K, new_K)]
        out[name] = (torch.from_numpy(new)
                     if isinstance(params[name], torch.Tensor) else new)
    return out
