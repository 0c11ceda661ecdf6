"""Share of the profiled sample's wall time in which no operation ran on
the device: 1 - (union of the kernels' intervals) / (the sample's wall
time), both from the sample alone. The profiler slows the host, not the
kernels, so the share is the idle share under the profiler; run.py
prints on standard error how much slower the sample answered than the
window before it."""


def read(rec):
    s = rec.get("sample")
    if not s or s["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])
