"""Device milliseconds busy a decode step: the union of the kernels'
intervals over the profiled sample of searches, over its decode steps."""


def read(rec):
    s = rec.get("sample")
    if not s or not rec.get("decode_steps") or s["busy_s"] <= 0:
        return None
    return s["busy_s"] / rec["decode_steps"] * 1e3
