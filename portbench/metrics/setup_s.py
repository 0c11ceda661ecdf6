"""Seconds from the start of the process to the start of the window:
imports, the card's start, the kernels' build or load, the weights, the
corpus and its trie, the engine and its warm-up."""


def read(rec):
    return rec["setup_s"]
