"""reorder_cache_all (K1) against its bound: the bytes its calls in the
profiled sample move (counts.k1_bytes, each distinct source slab read
once) at the HBM rate, over the device time of its launches."""
from portbench import counts


def read(rec):
    s = rec.get("sample")
    k = s and s["k1"]
    if not k or not k["launches"] or k["launches"] != k["calls"]:
        return None
    return counts.share_percent(counts.bound_s(k["bytes"]), k["seconds"])
