"""The program's ``codebook_head`` span (the final norm and the logits
over the position's codebook) against its bound: the operations and bytes
its steps in the profiled sample need (search_counts.head_work), bytes at
the HBM rate or operations at the bfloat16 tensor-core peak, whichever
takes longer, over the span's device time
(portbench/program_spans.py)."""
from portbench import counts, program_spans, search_counts


def read(rec):
    got = program_spans.read(rec)
    if not got or "codebook_head" not in got["spans"]:
        return None
    count, seconds = got["spans"]["codebook_head"]
    if count != len(got["steps"]):
        return None
    work = [search_counts.head_work(B, N, got["d_model"], got["K"])
            for B, N in got["steps"]]
    bound = search_counts.head_bound_s(sum(f for f, _ in work),
                                       sum(b for _, b in work))
    return counts.share_percent(bound, seconds)
