"""Declarative multi-stage pipeline runner with artifact manifests; a
copy of ripor_tpu/pipeline/runner.py whose stages run the port's CLI
(ripor_tpu_torch/cli/main.py). The manifest file is the same, so a
pipeline that either package started resumes in the other.

The reference chains its phases with bash scripts that invoke
`python -m t5_pretrainer.{main,evaluate,rerank}` and hand artifacts over
via directory conventions (full_scripts/*.sh — SURVEY.md §1 L0). Here a
pipeline is a JSON spec of named stages, each an argv for this package's
CLI; a manifest in the workspace records completed stages so an
interrupted pipeline resumes where it stopped (the reference's only
recovery is manual re-launch + checkpoint resume, SURVEY.md §5.3).

Spec format:
  {
    "workspace": "ws",
    "stages": [
      {"name": "phase1_pretrain", "argv": ["train", "--config", "p1.json"]},
      {"name": "encode", "argv": ["index", "--workspace", "ws", ...]},
      {"name": "docids", "argv": ["aq-index", ...]},
      {"name": "retrieve", "argv": ["retrieve", ...],
       "outputs": ["ws/run.json"]}
    ]
  }

A stage re-runs if (a) it is not in the manifest, or (b) any declared
output file is missing. ``--from STAGE`` forces a re-run from that stage on.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional


class PipelineManifest:
    def __init__(self, workspace: str | Path):
        self.path = Path(workspace) / "pipeline_manifest.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.completed: Dict[str, Dict] = {}
        if self.path.exists():
            self.completed = json.loads(self.path.read_text())

    def done(self, name: str, outputs: List[str]) -> None:
        self.completed[name] = {"ts": time.time(), "outputs": outputs}
        self.path.write_text(json.dumps(self.completed, indent=2))

    def is_done(self, name: str, outputs: List[str]) -> bool:
        if name not in self.completed:
            return False
        return all(Path(o).exists() for o in outputs)

    def invalidate_from(self, names: List[str], start: str) -> None:
        if start not in names:
            raise ValueError(f"unknown stage {start!r}; stages: {names}")
        for n in names[names.index(start):]:
            self.completed.pop(n, None)
        self.path.write_text(json.dumps(self.completed, indent=2))


def run_pipeline(spec: Dict, cli_main: Optional[Callable] = None,
                 from_stage: Optional[str] = None,
                 log: Callable[[str], None] = print) -> List[str]:
    """Execute the stages; returns the list of stage names that RAN."""
    if cli_main is None:
        from ripor_tpu_torch.cli.main import main as cli_main
    manifest = PipelineManifest(spec["workspace"])
    names = [s["name"] for s in spec["stages"]]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate stage names: {names}")
    if from_stage is not None:
        manifest.invalidate_from(names, from_stage)
    ran = []
    for stage in spec["stages"]:
        name = stage["name"]
        outputs = stage.get("outputs", [])
        if manifest.is_done(name, outputs):
            log(f"[pipeline] skip {name} (complete)")
            continue
        log(f"[pipeline] run {name}: {' '.join(stage['argv'])}")
        t0 = time.time()
        cli_main(stage["argv"])
        missing = [o for o in outputs if not Path(o).exists()]
        if missing:
            raise RuntimeError(
                f"stage {name!r} finished but outputs missing: {missing}")
        manifest.done(name, outputs)
        ran.append(name)
        log(f"[pipeline] {name} done in {time.time() - t0:.1f}s")
    return ran
