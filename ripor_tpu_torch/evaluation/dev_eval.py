"""In-training dev evaluation — unconstrained beam search over smtids.

Port of ripor_tpu/evaluation/dev_eval.py (reference trainer's
``evaluate()``, tasks/trainer.py:870-977): generate smtids for dev queries
WITHOUT the trie constraint, score a hit when a generated smtid equals a
relevant document's smtid, and report MRR@10 / recall@10 (metrics at
:963-965). Also ``first_smtid`` — argmax of the position-0 logits
(reference DenseRetriever.get_first_smtid, tasks/evaluator.py:733-751).
Both take the port's RiporModel (its weights, dtype and device) where the
JAX functions take params and a dtype.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ripor_tpu_torch.decode.beam import make_beam_search_fn
from ripor_tpu_torch.models.config import RiporConfig
from ripor_tpu_torch.trie.succinct import dummy_tables, tables_to_torch


def dev_eval(cfg: RiporConfig, model, query_batches, target_codes,
             num_beams: int = 10) -> Dict[str, float]:
    """query_batches: iterable of (ids, mask) fixed-shape batches covering
    the dev queries in order. ``target_codes``: either an [n_queries, M]
    array (ONE relevant smtid per query) or a sequence whose i-th element is
    a [P_i, M] array of ALL relevant smtids for query i (multi-positive
    qrels, scored against the full qrel as tasks/trainer.py:930-965).
    ``model``: a RiporModel; the search runs in its dtype on its device.
    Returns {"dev_mrr_10", "dev_recall_10"}.

    mrr@10: reciprocal rank of the first relevant beam; recall@10:
    fraction of the query's relevant smtids found in the top 10 (the
    reference's recall_k convention)."""
    device = next(model.parameters()).device
    fn = make_beam_search_fn(cfg, num_beams, constrained=False,
                             dtype=model.dtype, device=device)
    tables = tables_to_torch(dummy_tables(cfg.M), device)

    targets = [
        {tuple(int(c) for c in row) for row in np.atleast_2d(np.asarray(t))}
        for t in target_codes]

    rr, recalls, n = [], [], 0
    for ids, mask in query_batches:
        _, codes, _ = fn(model, ids, mask, tables)
        codes = codes.cpu().numpy()
        bz = codes.shape[0]
        for b in range(bz):
            if n >= len(targets):
                break
            rel = targets[n]
            rank, found = 0, 0
            for j in range(min(num_beams, 10)):
                if tuple(codes[b, j].tolist()) in rel:
                    found += 1
                    if rank == 0:
                        rank = j + 1
            rr.append(1.0 / rank if rank else 0.0)
            recalls.append(found / max(1, len(rel)))
            n += 1
    return {"dev_mrr_10": float(np.mean(rr)) if rr else 0.0,
            "dev_recall_10": float(np.mean(recalls)) if recalls else 0.0}


def first_smtid(cfg: RiporConfig, model, input_ids,
                attention_mask) -> np.ndarray:
    """Most likely first code per query (position-0 logits argmax)."""
    device = next(model.parameters()).device
    with torch.inference_mode():
        ids = torch.as_tensor(input_ids, device=device)
        hidden = model(ids, torch.as_tensor(attention_mask, device=device),
                       torch.zeros(ids.shape[0], 1, dtype=torch.long,
                                   device=device))
        logits = model.lm_logits(hidden)
    return torch.argmax(logits[:, 0], dim=-1).to(torch.int32).cpu().numpy()
