"""The program's ``select`` span against its bound: the bytes its steps
in the profiled sample need (search_counts.select_bytes) at the HBM rate,
over the span's device time (portbench/program_spans.py)."""
from portbench import counts, program_spans, search_counts


def read(rec):
    got = program_spans.read(rec)
    if not got or "select" not in got["spans"]:
        return None
    count, seconds = got["spans"]["select"]
    if count != len(got["steps"]):
        return None
    nbytes = sum(search_counts.select_bytes(B, N, got["K"], got["M"])
                 for B, N in got["steps"])
    return counts.share_percent(counts.bound_s(nbytes), seconds)
