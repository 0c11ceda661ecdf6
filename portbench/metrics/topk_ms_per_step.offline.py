"""Device milliseconds a decode step spends in the top-k and sort kernels
(names matched against topk_kernels.txt beside this file), over the
profiled sample."""
from pathlib import Path

NAMES = [ln.strip() for ln in
         (Path(__file__).parent / "topk_kernels.txt").read_text().splitlines()
         if ln.strip() and not ln.startswith("#")]


def read(rec):
    s = rec.get("sample")
    if not s or not rec.get("decode_steps"):
        return None
    sec = sum(t for name, (_, t) in s["kernels"].items()
              if any(n in name.lower() for n in NAMES))
    if sec <= 0:
        return None
    return sec / rec["decode_steps"] * 1e3
