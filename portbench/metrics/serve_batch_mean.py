"""Queries a batch the serving engine's microbatcher formed over the
window: the requests it served over the batches it ran
(RetrievalEngine.stats(): ``served`` and ``batch_hist``, their changes
across the window)."""


def read(rec):
    batches = rec.get("engine_batches")
    if not batches:
        return None
    return rec["engine_served"] / batches
