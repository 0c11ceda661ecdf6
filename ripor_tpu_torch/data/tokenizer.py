"""Tokenization — host-side preprocessing feeding fixed-shape token batches.

The reference uses HF's SentencePiece T5 tokenizer (dataset/dataloader.py:10).
This image has no pretrained tokenizer and zero egress, so the framework
ships its own: a trainable Unigram tokenizer (the same algorithm family as
SentencePiece, via the ``tokenizers`` Rust library) trained on the corpus,
plus a deterministic hash tokenizer for tests. Both emit right-padded
fixed-length int32 batches (static shapes).

Text prefixes match the reference ("query: ", "document: ";
dataset/dataset.py:15-16).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

import numpy as np

QUERY_PREFIX = "query: "
DOC_PREFIX = "document: "

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2
CLS_ID = 3
SEP_ID = 4


class TextTokenizer:
    """Base interface: encode str -> list[int] (no padding, no EOS)."""

    vocab_size: int

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L] int32, mask [B, L] int32); appends EOS (T5-style),
        truncates to max_length, right-pads with PAD_ID."""
        B = len(texts)
        ids = np.full((B, max_length), PAD_ID, np.int32)
        mask = np.zeros((B, max_length), np.int32)
        for i, t in enumerate(texts):
            toks = self.encode(t)[:max_length - 1] + [EOS_ID]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return ids, mask


class UnigramTokenizer(TextTokenizer):
    """SentencePiece-style Unigram tokenizer (tokenizers Rust backend)."""

    def __init__(self, tok):
        self._tok = tok
        self.vocab_size = tok.get_vocab_size()

    @staticmethod
    def train(corpus: Iterable[str], vocab_size: int = 32000) -> "UnigramTokenizer":
        """NOTE: the Rust Unigram trainer is nondeterministic run-to-run
        (internal hash-map ordering; no seed knob, independent of
        RAYON_NUM_THREADS) — persist the trained tokenizer.json and reload
        it for reproducible pipelines (stage_tokenizer does this); tests
        must not gate on exact-rank metrics across fresh trainings."""
        from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers
        tok = Tokenizer(models.Unigram())
        tok.normalizer = normalizers.NFKC()
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        trainer = trainers.UnigramTrainer(
            vocab_size=vocab_size,
            special_tokens=["<pad>", "</s>", "<unk>", "<cls>", "<sep>"],
            unk_token="<unk>")
        tok.train_from_iterator(corpus, trainer)
        return UnigramTokenizer(tok)

    @staticmethod
    def load(path: str | Path) -> "UnigramTokenizer":
        from tokenizers import Tokenizer
        return UnigramTokenizer(Tokenizer.from_file(str(path)))

    @staticmethod
    def from_spm(path: str | Path) -> "UnigramTokenizer":
        """Load a real SentencePiece ``.model`` file (e.g. T5's
        spiece.model, the tokenizer the reference uses at
        dataset/dataloader.py:10) so imported t5-base weights index the
        TRUE T5 vocab end-to-end. Parses the SPM proto with transformers'
        bundled pb2 (the sentencepiece C++ lib is not needed) and rebuilds
        it as a ``tokenizers`` Unigram model — the standard HF slow->fast
        conversion (T5Converter) recipe.

        T5's spm already places pad/eos/unk at ids 0/1/2, matching this
        module's PAD_ID/EOS_ID/UNK_ID constants."""
        from tokenizers import Regex, Tokenizer, models, normalizers, pre_tokenizers
        from transformers.utils import sentencepiece_model_pb2_new as spm_pb

        proto = spm_pb.ModelProto()
        proto.ParseFromString(Path(path).read_bytes())
        vocab = [(p.piece, p.score) for p in proto.pieces]
        unk_id = proto.trainer_spec.unk_id
        tok = Tokenizer(models.Unigram(vocab, unk_id=unk_id,
                                       byte_fallback=proto.trainer_spec.byte_fallback))
        norms = []
        charsmap = proto.normalizer_spec.precompiled_charsmap
        if charsmap:
            norms.append(normalizers.Precompiled(charsmap))
        norms.append(normalizers.Replace(Regex(" {2,}"), " "))
        tok.normalizer = normalizers.Sequence(norms)
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="always")
        return UnigramTokenizer(tok)

    def save(self, path: str | Path) -> None:
        self._tok.save(str(path))

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids


class WordTokenizer(TextTokenizer):
    """Deterministic word-level tokenizer: vocab = the ``vocab_size`` most
    frequent lowercase words (ties broken lexicographically), built in pure
    Python. Exists because the Rust Unigram trainer is nondeterministic
    run-to-run (see UnigramTokenizer.train) — CI recipes that gate on exact
    metrics train THIS tokenizer instead; production uses Unigram/SPM."""

    def __init__(self, vocab: dict):
        self._vocab = dict(vocab)
        self.vocab_size = 5 + len(self._vocab)

    @staticmethod
    def train(corpus: Iterable[str], vocab_size: int = 32000
              ) -> "WordTokenizer":
        import re
        from collections import Counter
        counts: Counter = Counter()
        for text in corpus:
            counts.update(re.findall(r"[a-z0-9]+", text.lower()))
        words = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return WordTokenizer({w: 5 + i
                              for i, (w, _) in enumerate(words[:vocab_size - 5])})

    def save(self, path: str | Path) -> None:
        import json
        Path(path).write_text(json.dumps({"kind": "word",
                                          "vocab": self._vocab}))

    @staticmethod
    def load(path: str | Path) -> "WordTokenizer":
        import json
        obj = json.loads(Path(path).read_text())
        if obj.get("kind") != "word":
            raise ValueError(f"{path} is not a WordTokenizer file")
        return WordTokenizer(obj["vocab"])

    def encode(self, text: str) -> List[int]:
        import re
        unk = UNK_ID
        return [self._vocab.get(w, unk)
                for w in re.findall(r"[a-z0-9]+", text.lower())]


class HashTokenizer(TextTokenizer):
    """Deterministic whitespace+hash tokenizer — test/bench stand-in with
    zero training cost. Ids in [3, vocab_size)."""

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        import zlib
        out = []
        for w in text.lower().split():
            h = zlib.crc32(w.encode()) % (self.vocab_size - 3)
            out.append(3 + h)
        return out


def tokenize_queries(tok: TextTokenizer, texts: Sequence[str], max_length: int):
    return tok.encode_batch([QUERY_PREFIX + t.strip() for t in texts], max_length)


def tokenize_docs(tok: TextTokenizer, texts: Sequence[str], max_length: int):
    return tok.encode_batch([DOC_PREFIX + t.strip() for t in texts], max_length)
