"""Collators: examples -> fixed-shape numpy batch dicts for each loss.

A copy of ripor_tpu/data/collators.py (numpy only): the port imports no
ripor_tpu module, since any of them loads jax.

Mirror the reference collators (dataset/data_collator.py:11-223) but emit
the batch keys consumed by ripor_tpu_torch.train.losses, with smtids as
pure code arrays (no -1 sentinel — the shift-right happens inside the
model).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ripor_tpu_torch.data.datasets import (
    BceExamples,
    Collection,
    Seq2SeqExamples,
    TeacherScoreExamples,
    parse_smtid_str,
)
from ripor_tpu_torch.data.tokenizer import (
    CLS_ID,
    EOS_ID,
    PAD_ID,
    SEP_ID,
    TextTokenizer,
    tokenize_docs,
    tokenize_queries,
)


def _codes_of(item, docid_to_codes: Optional[Dict[str, np.ndarray]],
              smtid_as_docid: bool) -> np.ndarray:
    if smtid_as_docid:
        return np.asarray(parse_smtid_str(item), np.int32)
    return docid_to_codes[str(item)]


class MarginMSECollator:
    """Batches for t5seq_aq_encoder_margin_mse (reference
    MarginMSEforT5SeqAQCollator, data_collator.py:115-150)."""

    def __init__(self, tokenizer: TextTokenizer, queries: Collection,
                 docid_to_codes: Optional[Dict[str, np.ndarray]],
                 max_length: int = 64, smtid_as_docid: bool = False,
                 prefix_lengths: Tuple[int, ...] = ()):
        self.tok = tokenizer
        self.queries = queries
        self.d2c = docid_to_codes
        self.max_length = max_length
        self.smtid_as_docid = smtid_as_docid
        self.prefix_lengths = prefix_lengths

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        q_texts = [self.queries[s["qid"]] for s in samples]
        ids, mask = tokenize_queries(self.tok, q_texts, self.max_length)
        pos = np.stack([_codes_of(s["pos"], self.d2c, self.smtid_as_docid)
                        for s in samples])
        neg = np.stack([_codes_of(s["neg"], self.d2c, self.smtid_as_docid)
                        for s in samples])
        batch = {
            "query_ids": ids, "query_mask": mask,
            "pos_codes": pos.astype(np.int32), "neg_codes": neg.astype(np.int32),
            "teacher_pos_score": np.asarray([s["pos_score"] for s in samples], np.float32),
            "teacher_neg_score": np.asarray([s["neg_score"] for s in samples], np.float32),
        }
        for p in self.prefix_lengths:
            batch[f"smtid_{p}_teacher_pos_score"] = np.asarray(
                [s[f"smtid_{p}_pos_score"] for s in samples], np.float32)
            batch[f"smtid_{p}_teacher_neg_score"] = np.asarray(
                [s[f"smtid_{p}_neg_score"] for s in samples], np.float32)
        return batch


class Seq2SeqCollator:
    """Batches for t5seq_aq_encoder_seq2seq (reference
    Seq2SeqForT5SeqAQCollator, data_collator.py:90-113)."""

    def __init__(self, tokenizer: TextTokenizer,
                 docid_to_codes: Dict[str, np.ndarray], max_length: int = 64):
        self.tok = tokenizer
        self.d2c = docid_to_codes
        self.max_length = max_length

    def __call__(self, samples: Sequence[Tuple[str, str]]) -> Dict[str, np.ndarray]:
        ids, mask = tokenize_queries(self.tok, [q for _, q in samples],
                                     self.max_length)
        codes = np.stack([self.d2c[str(d)] for d, _ in samples]).astype(np.int32)
        return {"query_ids": ids, "query_mask": mask, "codes": codes}


class PretrainCollator:
    """Batches for phase-1 t5seq_pretrain_margin_mse (reference
    MarginMSEforPretrainCollator, data_collator.py:152-223)."""

    def __init__(self, tokenizer: TextTokenizer, queries: Collection,
                 documents: Collection, max_length: int = 128,
                 docid_to_codes: Optional[Dict[str, np.ndarray]] = None,
                 prefix_len: int = 0):
        self.tok = tokenizer
        self.queries = queries
        self.documents = documents
        self.max_length = max_length
        self.d2c = docid_to_codes
        self.prefix_len = prefix_len

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        q_ids, q_mask = tokenize_queries(
            self.tok, [self.queries[s["qid"]] for s in samples], self.max_length)
        pd_ids, pd_mask = tokenize_docs(
            self.tok, [self.documents[s["pos"]] for s in samples], self.max_length)
        nd_ids, nd_mask = tokenize_docs(
            self.tok, [self.documents[s["neg"]] for s in samples], self.max_length)
        batch = {
            "query_ids": q_ids, "query_mask": q_mask,
            "pos_doc_ids": pd_ids, "pos_doc_mask": pd_mask,
            "neg_doc_ids": nd_ids, "neg_doc_mask": nd_mask,
            "teacher_pos_score": np.asarray([s["pos_score"] for s in samples], np.float32),
            "teacher_neg_score": np.asarray([s["neg_score"] for s in samples], np.float32),
        }
        if self.d2c is not None and self.prefix_len > 0:
            batch["pos_prefix_codes"] = np.stack(
                [self.d2c[str(s["pos"])][:self.prefix_len] for s in samples]).astype(np.int32)
            batch["neg_prefix_codes"] = np.stack(
                [self.d2c[str(s["neg"])][:self.prefix_len] for s in samples]).astype(np.int32)
        return batch


class T5SeqBceCollator:
    """Batches for t5seq_bce: (qid, docid, label) -> query tokens + the
    doc's smtid codes + label (reference T5SeqCrossEncoder.forward inputs,
    modeling/cross_encoder.py:75-92)."""

    def __init__(self, tokenizer: TextTokenizer, queries: Collection,
                 docid_to_codes: Dict[str, np.ndarray], max_length: int = 128):
        self.tok = tokenizer
        self.queries = queries
        self.d2c = docid_to_codes
        self.max_length = max_length

    def __call__(self, samples: Sequence[Tuple[str, str, int]]
                 ) -> Dict[str, np.ndarray]:
        ids, mask = tokenize_queries(
            self.tok, [self.queries[q] for q, _, _ in samples], self.max_length)
        codes = np.stack([self.d2c[str(d)] for _, d, _ in samples])
        return {"query_ids": ids, "query_mask": mask,
                "codes": codes.astype(np.int32),
                "labels": np.asarray([l for _, _, l in samples], np.float32)}


class BertBceCollator:
    """Batches for bert_bce: (qid, docid, label) -> [CLS] q [SEP] d [EOS]
    pair encodings with token_type_ids (reference CrossEncoder qd_kwargs,
    modeling/cross_encoder.py:17-23 via the HF pair tokenizer)."""

    def __init__(self, tokenizer: TextTokenizer, queries: Collection,
                 documents: Collection, max_length: int = 128):
        self.tok = tokenizer
        self.queries = queries
        self.documents = documents
        self.max_length = max_length

    def __call__(self, samples: Sequence[Tuple[str, str, int]]
                 ) -> Dict[str, np.ndarray]:
        B, L = len(samples), self.max_length
        ids = np.full((B, L), PAD_ID, np.int32)
        mask = np.zeros((B, L), np.int32)
        types = np.zeros((B, L), np.int32)
        for i, (qid, did, _) in enumerate(samples):
            q_ids = self.tok.encode(self.queries[qid])[: L // 3]
            d_ids = self.tok.encode(self.documents[did])[: L - len(q_ids) - 3]
            row = [CLS_ID] + q_ids + [SEP_ID] + d_ids + [EOS_ID]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
            types[i, len(q_ids) + 2:len(row)] = 1  # doc segment
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": types,
                "labels": np.asarray([l for _, _, l in samples], np.float32)}


def batches_from_bce(examples: BceExamples, collator, batch_size: int,
                     seed: int = 0, epochs: int = 1, drop_last: bool = True,
                     process_index: int = 0, process_count: int = 1,
                     start_batch: int = 0) -> Iterator[Dict]:
    """Shuffled epoch iterator over BCE rows (same sharding contract as
    batches_from_teacher_examples)."""
    emitted = 0
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(examples))[process_index::process_count]
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            emitted += 1
            if emitted <= start_batch:
                continue
            yield collator([examples[int(i)] for i in idx])


def batches_from_teacher_examples(
        examples: TeacherScoreExamples, collator, batch_size: int,
        seed: int = 0, epochs: int = 1, drop_last: bool = True,
        process_index: int = 0, process_count: int = 1,
        start_batch: int = 0) -> Iterator[Dict]:
    """Shuffled epoch iterator with per-process sharding (replaces
    DistributedSampler; SURVEY.md §5.8).

    ``start_batch``: fast-resume — skip the first N batches at the index
    level without tokenizing/collating them (pass Trainer.resume_step; the
    reference fast-forwards its sampler the same way). Note negative
    sampling draws from the same epoch rng stream as the shuffle, so the
    skip replays sample_pair's rng draws cheaply via rng state advancement
    on indices only."""
    prefix_keys = getattr(collator, "prefix_lengths", ())
    emitted = 0
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(examples))
        order = order[process_index::process_count]
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            emitted += 1
            if emitted <= start_batch:
                # keep the rng stream identical to a non-skipped run:
                # draw (and discard) the same per-sample negatives
                for i in idx:
                    examples.sample_pair(int(i), rng, ())
                continue
            samples = [examples.sample_pair(int(i), rng, prefix_keys)
                       for i in idx]
            yield collator(samples)


def batches_from_joint(rank_batches: Iterator[Dict],
                       s2s_examples: Seq2SeqExamples,
                       s2s_collator: Seq2SeqCollator,
                       batch_size: int, seed: int = 0) -> Iterator[Dict]:
    """Zip a rank-batch iterator with an endlessly cycling seq2seq batch
    stream for the joint ``t5seq_aq_encoder_lng_knp_margin_mse_and_
    seq2seq`` loss (reference arguments.py:97): each yielded batch carries
    the rank keys plus the seq2seq sub-batch under ``s2s_`` prefixes. The
    seq2seq stream reshuffles each wrap (seed advances) and keeps a fixed
    batch shape (drop_last within an epoch; full-dataset batch when the
    dataset is smaller than ``batch_size``) so every step has one shape."""
    bz = min(batch_size, len(s2s_examples))

    def s2s_forever():
        e = 0
        while True:
            yielded = False
            for b in batches_from_seq2seq(s2s_examples, s2s_collator, bz,
                                          seed=seed + 31 * e, epochs=1,
                                          drop_last=True):
                yielded = True
                yield b
            e += 1
            if not yielded:      # degenerate tiny dataset: single batch
                yield s2s_collator([s2s_examples[i]
                                    for i in range(len(s2s_examples))])

    s2s = s2s_forever()
    for rb in rank_batches:
        out = dict(rb)
        out.update({f"s2s_{k}": v for k, v in next(s2s).items()})
        yield out


def batches_from_seq2seq(examples: Seq2SeqExamples, collator: Seq2SeqCollator,
                         batch_size: int, seed: int = 0, epochs: int = 1,
                         drop_last: bool = True, process_index: int = 0,
                         process_count: int = 1,
                         start_batch: int = 0) -> Iterator[Dict]:
    emitted = 0
    for epoch in range(epochs):
        rng = np.random.default_rng(seed + epoch)
        order = rng.permutation(len(examples))[process_index::process_count]
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[s:s + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            emitted += 1
            if emitted <= start_batch:
                continue
            yield collator([examples[int(i)] for i in idx])
