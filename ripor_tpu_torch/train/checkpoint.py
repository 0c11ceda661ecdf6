"""Model checkpoints in PyTorch's idiom, and a reader of the JAX package's.

Counterpart of ripor_tpu/train/checkpoint.py's ``save_params`` and
``load_params``. A checkpoint directory holds

  params.pt      a RiporModel state_dict of CPU tensors (``torch.save``)
  config.json    the RiporConfig (``RiporConfig.to_json``)

``load_params`` also reads a checkpoint the JAX package saved: an Orbax
``StandardCheckpointer`` tree under ``params/`` (OCDBT key-value store,
zarr arrays). It reads each leaf through ``tensorstore``, imported only
there, and maps the tree with ``params_from_jax``. ``params.pt`` is read
first when both exist. ``resize_codebooks`` and ``CheckpointManager`` wait
for the training slice (ROADMAP.md Queue 1 item 10).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.models.convert import params_from_jax

PARAMS_FILE = "params.pt"


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


def load_params(path: str | Path,
                cfg: Optional[RiporConfig] = None) -> Dict[str, torch.Tensor]:
    """State dict for ``RiporModel(cfg)`` from a checkpoint directory:
    ``params.pt`` when it exists, else the JAX package's Orbax ``params/``
    (``cfg`` defaults to ``path/config.json``; the tree must fit it)."""
    path = Path(path).absolute()
    if (path / PARAMS_FILE).exists():
        return torch.load(path / PARAMS_FILE, map_location="cpu",
                          weights_only=True)
    if not (path / "params").is_dir():
        raise FileNotFoundError(f"no {PARAMS_FILE} and no Orbax params/ "
                                f"directory in {path}")
    if cfg is None:
        cfg = RiporConfig.load(path / "config.json")
    return params_from_jax(read_orbax_tree(path / "params"), cfg)


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
