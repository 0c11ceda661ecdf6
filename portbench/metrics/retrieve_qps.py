"""Queries whose top-k list came back in the window, over the window's
seconds (the window closes when the batch in flight at its end is back)."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return rec["answered"] / rec["window_s"]
