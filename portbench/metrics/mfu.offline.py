"""Model operations the searches completed need (counts.search_flops: the
queries' own tokens, the beams alive at each step) over the seconds of the
traced window outside the profiled sample, as a share of the H100's dense
bfloat16 peak."""
from portbench import counts


def read(rec):
    if "mfu_flops" not in rec:
        return None
    return counts.mfu_percent(rec["mfu_flops"], rec["mfu_seconds"])
