"""Build, load and launch-check the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (one entry per kernel, taking raw
pointers plus the CUDA stream and returning ``cudaGetLastError()``) and
bound with ``ctypes``. The build runs at the first CUDA launch, never at
import: one ``nvcc`` per source, all started together, into
``build/ripor_tpu_torch/<hash>/`` beside the package, where ``<hash>``
covers every file in ``csrc/`` and the compiler flags — a changed source
rebuilds, an unchanged one loads.

No ``--use_fast_math``: the row codec (csrc/row_codec.cuh) relies on IEEE
division, ``log2f`` and ``rintf`` to stay bit-identical to its plain
PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "ripor_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

# launches per kernel wrapper; the wrappers add one where they launch
# their kernel and nowhere else (chip_smoke.py zeroes and reads them)
KERNEL_LAUNCHES: Dict[str, int] = {
    "reorder_cache_all": 0,
    "step_attention_seq": 0,
    "beam_gather_rows": 0,
    "step_attend_reorder": 0,
    "step_attention_fused": 0,
    "beam_gather_update": 0,
    "step_attention": 0,
    "beam_gather_blocks": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the "
            "ripor_tpu_torch CUDA kernels cannot be built")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns
    {source stem: CDLL}. Thread-safe and idempotent."""
    with _lock:
        if _libs:
            return _libs
        out_dir = BUILD_ROOT / _source_hash()
        sources = sorted(CSRC.glob("*.cu"))
        todo = [s for s in sources
                if not (out_dir / f"lib{s.stem}.so").exists()]
        t0 = time.monotonic()
        if todo:
            nvcc = _nvcc()
            out_dir.mkdir(parents=True, exist_ok=True)
            procs = []
            for src in todo:
                tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(src)]
                procs.append((src, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            logs = []
            failed = []
            for src, tmp, p in procs:
                log, _ = p.communicate()
                logs.append(f"== {src.name} (rc {p.returncode})\n{log}")
                if p.returncode != 0:
                    failed.append(src.name)
                else:
                    os.replace(tmp, out_dir / f"lib{src.stem}.so")
            (out_dir / "build.log").write_text("\n".join(logs))
            if failed:
                raise RuntimeError(
                    f"nvcc failed for {failed}:\n" + "\n".join(logs))
        BUILD_INFO.update(dir=str(out_dir), built=[s.name for s in todo],
                          seconds=time.monotonic() - t0)
        for src in sources:
            _libs[src.stem] = ctypes.CDLL(str(out_dir / f"lib{src.stem}.so"))
        return _libs


def kernel_fn(lib: str, name: str, nargs_ptr: int, nargs_int: int):
    """The C entry ``name`` of ``lib<lib>.so`` with its argtypes set:
    ``nargs_ptr`` pointers, then ``nargs_int`` 64-bit ints, then the
    stream. Builds the libraries on first use."""
    fn = getattr(build_all()[lib], name)
    fn.argtypes = ([ctypes.c_void_p] * nargs_ptr
                   + [ctypes.c_longlong] * nargs_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, name: str) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    KERNEL_LAUNCHES[name] += 1


def device_kind(*tensors) -> str:
    """"cpu" when every tensor lies on the CPU (the plain version runs),
    "cuda" when every tensor lies on one CUDA device (the kernel runs);
    anything else raises — there is no fallback."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return dev.type


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_disjoint(src, dst, what: str) -> None:
    """Raise unless the buffers of ``src`` and ``dst`` do not overlap (a
    kernel that reads ``src`` while it writes ``dst``)."""
    a, b = src.data_ptr(), dst.data_ptr()
    na = src.numel() * src.element_size()
    nb = dst.numel() * dst.element_size()
    require(a + na <= b or b + nb <= a, f"{what} must not alias its source")
