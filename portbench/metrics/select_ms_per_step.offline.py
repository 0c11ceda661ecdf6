"""Device milliseconds a decode step spends in the program's ``select``
span (the trie mask, the top-k over the N*K candidates and the beams'
bookkeeping), over the profiled sample's decode steps
(portbench/program_spans.py). None where the spans do not match the
profiled steps one for one (a dropped annotation would under-read)."""
from portbench import program_spans


def read(rec):
    got = program_spans.read(rec)
    if not got or "select" not in got["spans"] or not rec.get("decode_steps"):
        return None
    count, seconds = got["spans"]["select"]
    if count != len(got["steps"]):
        return None
    return seconds / rec["decode_steps"] * 1e3
