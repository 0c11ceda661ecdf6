"""Tracing / profiling / metrics, in PyTorch.

Port of ripor_tpu/utils/observability.py:

* ``profile_trace`` — a torch.profiler trace (host, and the card's kernels
  where CUDA is present) written as a Chrome trace into a directory.
* ``StepTimer`` — step timing with warmup skip + percentile summary + MFU
  given a per-step FLOP estimate. On CUDA a step is timed by CUDA events
  recorded on the stream around it, so the time is the device's, not the
  time Python took to enqueue the step; MFU is taken against the card's
  peak for the compute dtype (``PEAK_FLOPS``).
* ``MetricsLogger`` — JSONL metrics sink with optional wandb mirroring
  (rank-0 gated, like the reference's main.py:160-162); a copy.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# Dense (no sparsity) peak rates of one NVIDIA H100 SXM5 at its 700 W power
# limit, from NVIDIA's H100 Tensor Core GPU datasheet, keyed by the name
# torch.cuda.get_device_name gives the card and by the compute dtype of the
# matmuls ("tf32": float32 matmuls with torch.backends.cuda.matmul.
# allow_tf32 on). float32 without TF32 runs outside the tensor cores.
PEAK_FLOPS = {
    ("NVIDIA H100 80GB HBM3", torch.float32): 67e12,
    ("NVIDIA H100 80GB HBM3", "tf32"): 495e12,
    ("NVIDIA H100 80GB HBM3", torch.bfloat16): 989e12,
    ("NVIDIA H100 80GB HBM3", torch.float16): 989e12,
}


def peak_flops(device_name: str, dtype=torch.float32) -> Optional[float]:
    """The table's peak for this card and compute dtype, else None."""
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        dtype = "tf32"
    return PEAK_FLOPS.get((device_name, dtype))


@contextlib.contextmanager
def profile_trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Capture a trace: ``with profile_trace('/tmp/trace') as prof:
    step()``; writes ``log_dir/trace.json`` on exit (open it in
    chrome://tracing or Perfetto) and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def estimate_train_flops_per_token(n_params: int) -> float:
    """6 * params per token (fwd 2x + bwd 4x), the standard estimate."""
    return 6.0 * n_params


class StepTimer:
    """``with timer: step()`` around each step. ``device``: where the step
    runs (CUDA: timed by events on the current stream, read back without
    stalling the next step; else the host clock). MFU needs a known peak
    (``peak_flops``) and ``flops_per_step``."""

    def __init__(self, warmup: int = 2,
                 flops_per_step: Optional[float] = None,
                 device=None, dtype=torch.float32, n_devices: int = 1):
        self.warmup = warmup
        self.flops_per_step = flops_per_step
        self.device = torch.device(device if device is not None else "cpu")
        self.cuda = self.device.type == "cuda"
        peak = (peak_flops(torch.cuda.get_device_name(self.device), dtype)
                if self.cuda else None)
        self.peak = peak * n_devices if peak else None
        self.times: list = []
        self._pending: list = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._n += 1
        keep = self._n > self.warmup
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if keep:
                self._pending.append((self._t0, end))
            self._collect(wait=False)
        else:
            dt = time.perf_counter() - self._t0
            if keep:
                self.times.append(dt)

    def _collect(self, wait: bool) -> None:
        """Move finished event pairs into ``times`` (all of them, waiting
        for the device, when ``wait``)."""
        while self._pending and (wait or self._pending[0][1].query()):
            start, end = self._pending.pop(0)
            end.synchronize()
            self.times.append(start.elapsed_time(end) / 1e3)

    def summary(self) -> Dict[str, float]:
        self._collect(wait=True)
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        out = {
            "steps": int(len(arr)),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
        if self.flops_per_step and self.peak:
            out["mfu"] = float(self.flops_per_step / arr.mean() / self.peak)
        return out


class MetricsLogger:
    """Append-only JSONL metrics + optional wandb (never required)."""

    def __init__(self, path: Optional[str | Path] = None,
                 wandb_project: Optional[str] = None, rank: int = 0):
        self.path = Path(path) if path else None
        self.rank = rank
        self._wandb = None
        if wandb_project and rank == 0:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project)
            except Exception:
                self._wandb = None
        if self.path and rank == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if self.rank != 0:
            return
        rec = {"step": step, "ts": time.time(), **metrics}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def __call__(self, metrics: Dict[str, float], step: int) -> None:
        self.log(metrics, step)
