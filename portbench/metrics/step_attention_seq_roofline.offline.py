"""step_attention_seq (K2) against its bound: the bytes its calls in the
profiled sample move (counts.k2_bytes) at the HBM rate, or its float32
operations at the CUDA cores' rate where that takes longer, over the
device time of its launches."""
from portbench import counts


def read(rec):
    s = rec.get("sample")
    k = s and s["k2"]
    if not k or not k["launches"] or k["launches"] != k["calls"]:
        return None
    return counts.share_percent(counts.bound_s(k["bytes"], k["flops"]),
                                k["seconds"])
