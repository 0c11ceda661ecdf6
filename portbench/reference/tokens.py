"""The query's token ids, worked out from its text as the deployment's
tokenizer defines them: the words of ``"query: " + text`` (lower-cased,
split on white space), each hashed by CRC-32 into [3, vocab_size), cut to
``max_length - 1`` and closed by the end-of-sequence id 1."""
from __future__ import annotations

import zlib
from typing import List

EOS = 1
PREFIX = "query: "


def query_ids(text: str, vocab_size: int, max_length: int) -> List[int]:
    words = (PREFIX + text.strip()).lower().split()
    ids = [3 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in words]
    return ids[:max_length - 1] + [EOS]
