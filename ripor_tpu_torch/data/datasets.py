"""Dataset readers — same on-disk formats as the reference.

A copy of ripor_tpu/data/datasets.py (stdlib and numpy only): the port
imports no ripor_tpu module, since any of them loads jax.

Formats (reference dataset/dataset.py):
  * collection dir with ``raw.tsv``: "<id>\\t<text>" per line
    (CollectionDatasetPreLoad :231-264)
  * ``docid_to_smtid.json``: {docid: [-1, c1..cM]} (leading -1 sentinel;
    asserted at :376,439,573 — stripped on load here)
  * teacher-score trainset JSONL: {"qid":…, "docids":[…], "scores":[…]}
    with the positive at index 0 and sampled negatives from 1..
    (MarginMSEforT5SeqAQDataset :552-616); ``smtid_as_docid`` variant uses
    {"smtids": ["c1_c2_…", …]} (:599-610); LngKnp adds "smtid_{4,8,16}_scores"
    keyed by prefix length (:443-458)
  * seq2seq examples JSONL: {"docid":…, "query":…} (:527-550)
  * qrel JSON: {qid: {docid: rel}}
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


class Collection:
    """id -> text map from a ``raw.tsv`` (docs or queries)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        if path.is_dir():
            path = path / "raw.tsv"
        self.ids: List[str] = []
        self.texts: List[str] = []
        self._idx: Dict[str, int] = {}
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                id_, text = line.rstrip("\n").split("\t", 1)
                self._idx[id_] = len(self.ids)
                self.ids.append(id_)
                self.texts.append(text)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, id_: str) -> str:
        return self.texts[self._idx[str(id_)]]

    def text_at(self, i: int) -> str:
        return self.texts[i]

    def shard(self, rank: int, nranks: int) -> "Collection":
        """Strided per-process slice (DistributedSampler semantics: row i
        belongs to rank i % nranks — reference evaluate.py:457-487 shards
        the query set this way for multi-GPU decode)."""
        out = object.__new__(Collection)
        out.ids = self.ids[rank::nranks]
        out.texts = self.texts[rank::nranks]
        out._idx = {id_: i for i, id_ in enumerate(out.ids)}
        return out


def load_docid_to_smtid(path: str | Path) -> Tuple[List[str], np.ndarray]:
    """-> (docids in file order, codes [N, M] int32). Strips the reference's
    leading -1 sentinel."""
    with open(path) as f:
        d2s = json.load(f)
    docids = list(d2s.keys())
    rows = []
    for did in docids:
        codes = d2s[did]
        if codes and codes[0] == -1:
            codes = codes[1:]
        rows.append(codes)
    return docids, np.asarray(rows, np.int32)


def save_docid_to_smtid(path: str | Path, docids: List[str],
                        codes: np.ndarray) -> None:
    """Write the reference-compatible format (with -1 sentinel)."""
    out = {str(d): [-1] + [int(c) for c in row]
           for d, row in zip(docids, np.asarray(codes))}
    with open(path, "w") as f:
        json.dump(out, f)


def parse_smtid_str(s: str) -> List[int]:
    """'c1_c2_…' -> [c1, c2, …] (reference :599-610)."""
    return [int(x) for x in s.split("_")]


def smtid_to_str(codes) -> str:
    """[c1..cm] -> 'c1_c2_…' (reference convert_ptsmtids_to_strsmtid,
    utils/utils.py:46-59, minus the leading -1)."""
    return "_".join(str(int(c)) for c in codes)


class TeacherScoreExamples:
    """JSONL of {"qid", "docids"|"smtids", "scores"(, "smtid_*_scores")}."""

    def __init__(self, path: str | Path, smtid_as_docid: bool = False):
        self.examples = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    self.examples.append(json.loads(line))
        self.smtid_as_docid = smtid_as_docid
        key = "smtids" if smtid_as_docid else "docids"
        for ex in self.examples[:16]:
            assert key in ex and "scores" in ex and len(ex[key]) == len(ex["scores"])

    def __len__(self):
        return len(self.examples)

    def sample_pair(self, idx: int, rng: np.random.Generator,
                    prefix_keys: Tuple[int, ...] = ()) -> Dict:
        """Positive at 0, negative sampled uniformly from 1.. (reference
        :589-595). Returns qid, pos/neg ids, scores, and per-prefix scores."""
        ex = self.examples[idx]
        key = "smtids" if self.smtid_as_docid else "docids"
        n = len(ex[key])
        neg = int(rng.integers(1, n)) if n > 1 else 0
        out = {
            "qid": str(ex["qid"]),
            "pos": ex[key][0], "neg": ex[key][neg],
            "pos_score": float(ex["scores"][0]),
            "neg_score": float(ex["scores"][neg]),
        }
        for p in prefix_keys:
            out[f"smtid_{p}_pos_score"] = float(ex[f"smtid_{p}_scores"][0])
            out[f"smtid_{p}_neg_score"] = float(ex[f"smtid_{p}_scores"][neg])
        return out

    def prefix_lengths_present(self) -> Tuple[int, ...]:
        ex = self.examples[0]
        return tuple(p for p in (4, 8, 16) if f"smtid_{p}_scores" in ex)


class Seq2SeqExamples:
    """JSONL of {"docid", "query"} pairs (pseudo-queries or train queries)."""

    def __init__(self, path: str | Path):
        self.examples: List[Tuple[str, str]] = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    ex = json.loads(line)
                    self.examples.append((str(ex["docid"]), ex["query"]))

    def __len__(self):
        return len(self.examples)

    def __getitem__(self, i):
        return self.examples[i]


class BceExamples:
    """TSV of "qid\\tdocid\\tlabel" rows — the cross-encoder classification
    trainset (reference aq_preprocess/build_bce_example_for_t5seq_encoder.py:
    69-71; consumed by loss_type bert_bce / t5seq_bce)."""

    def __init__(self, path: str | Path):
        self.rows: List[Tuple[str, str, int]] = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    qid, docid, label = line.rstrip("\n").split("\t")
                    self.rows.append((qid, docid, int(label)))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def build_bce_examples(qrel: Dict[str, Dict[str, int]],
                       run: Dict[str, Dict[str, float]],
                       neg_sample: int = 50, seed: int = 4680
                       ) -> List[Tuple[str, str, int]]:
    """(qid, docid, label) rows: each rel doc paired with ``neg_sample``
    negatives drawn from the query's run candidates (reference
    build_bce_example_for_t5seq_encoder.py:57-68; shuffled like :68)."""
    rng = np.random.default_rng(seed)
    rows: List[Tuple[str, str, int]] = []
    for qid, rels in qrel.items():
        cands = list(run.get(str(qid), {}))
        if not cands:
            continue
        for rel_docid, r in rels.items():
            if r <= 0:
                continue
            k = min(neg_sample, len(cands))
            for neg in rng.choice(len(cands), size=k, replace=False):
                rows.append((str(qid), str(rel_docid), 1))
                rows.append((str(qid), str(cands[int(neg)]), 0))
    order = rng.permutation(len(rows))
    return [rows[int(i)] for i in order]


def save_bce_examples(path: str | Path,
                      rows: List[Tuple[str, str, int]]) -> None:
    with open(path, "w") as f:
        for qid, docid, label in rows:
            f.write(f"{qid}\t{docid}\t{label}\n")


def load_qrel(path: str | Path) -> Dict[str, Dict[str, int]]:
    with open(path) as f:
        return json.load(f)
