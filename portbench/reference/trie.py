"""The reference's trie, built from the corpus's codes: the documents
sorted by their codes, so that every prefix of t codes is one run
[lo, hi) of the sorted documents and its children are the runs of t + 1
codes inside it."""
from __future__ import annotations

import numpy as np


class PrefixRuns:
    def __init__(self, codes: np.ndarray, K: int):
        codes = np.asarray(codes)
        n, self.M = codes.shape
        bits = max(1, int(K - 1).bit_length())
        per = 63 // bits
        words = [np.zeros(n, np.int64) for _ in range(-(-self.M // per))]
        for j in range(self.M):
            words[j // per] = words[j // per] * K + codes[:, j]
        # lexicographic order of the codes: the first word is the primary key
        self.order = np.lexsort(words[::-1])
        self.codes = codes[self.order]
        diff = self.codes[1:] != self.codes[:-1]
        # the first position at which each document's codes differ from the
        # previous document's (M: the same codes)
        self.first = np.where(diff.any(1), diff.argmax(1), self.M)
        self.n = n
        self._starts = {}

    def starts(self, t: int) -> np.ndarray:
        """Where each run of t + 1 codes begins, ascending."""
        if t not in self._starts:
            self._starts[t] = np.concatenate(
                [[0], 1 + np.flatnonzero(self.first <= t)])
        return self._starts[t]

    def children(self, lo: np.ndarray, hi: np.ndarray, t: int):
        """The children of the runs [lo, hi) of t codes: (parent index,
        code at position t, child lo, child hi), parent-major."""
        s = np.append(self.starts(t), self.n)
        a = np.searchsorted(s, lo)
        b = np.searchsorted(s, hi)
        count = b - a
        parent = np.repeat(np.arange(len(lo)), count)
        k = np.arange(count.sum()) - np.repeat(np.cumsum(count) - count,
                                               count) + np.repeat(a, count)
        return parent, self.codes[s[k], t], s[k], s[k + 1]

    def documents(self, lo: int, hi: int) -> np.ndarray:
        return self.order[lo:hi]
