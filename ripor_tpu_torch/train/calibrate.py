"""Teacher-score scale calibration for MarginMSE-family stages, in PyTorch.

Port of ripor_tpu/train/calibrate.py: the same sampling (numpy
``default_rng(seed)`` and ``TeacherScoreExamples.sample_pair``), so the
same pairs are drawn; the student's margins come from a no-grad
``RiporModel.forward`` with float32 per-position dots.

The student's ranking score is a raw sequential dot-product sum
Σ_{i<=m} <q_i, d_i> (reference t5_generative_retriever.py:931-935) while
the teacher emits cross-encoder logits. At the reference's scale the
mismatch is absorbed implicitly: phase-2 MarginMSE runs 250k steps over
500k queries (full_train_t5seq_seq2seq_0_1_pipeline.sh:55-72), so the
student's score scale is recalibrated long before any single example
repeats. At slice scale the same loss is catastrophic — measured r3/r4:
the MSE's scale-recalibration transient (student margins 31±48 vs teacher
11±4 at the phase-2 checkpoint) reorders what seq2seq built faster than
the margins can be fit, regressing BOTH train and dev MRR (VERDICT.md r3
missing #1/#2; artifacts/phase3_dynamics_r3.md).

The fix is one scalar per score column, applied at DATAGEN time: scale
the teacher's scores by the least-squares coefficient

    alpha* = argmin_a E[(s - a*t)^2] = Σ s_i t_i / Σ t_i^2

over sampled (student margin s, teacher margin t) pairs from the actual
trainset at the current checkpoint. alpha* minimizes the initial MSE by
construction, so the remaining gradient works on REORDERING (the signal)
instead of global rescaling (the transient). MarginMSE consumes only
score DIFFERENCES, so a multiplicative calibration is exactly a margin
calibration; additive shifts cancel and are not needed.

Prefix heads (lng_knp, reference :942-962) get their own alpha: the
student's prefix-p margin is a sum over p dots, so its natural scale
differs from the full-length margin's — one global scalar cannot match
both (the reference's fixed MNT factors 0.5/0.75/0.875 are the same idea
with an unmeasured constant).
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ripor_tpu_torch.data.collators import MarginMSECollator
from ripor_tpu_torch.data.datasets import TeacherScoreExamples
from ripor_tpu_torch.models.ripor import RiporModel


def _score_fn(model: RiporModel, params):
    """(query, codes) -> per-position sequential dots [B, m] f32 of the
    pos and neg codes, as numpy; ``params`` (a state_dict, or None for
    the weights ``model`` holds) is loaded into ``model`` first."""
    if params is not None:
        model.load_state_dict(params)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def scores(qi, qm, pos, neg):
        qi, qm = (torch.as_tensor(a, device=dev) for a in (qi, qm))

        def one(codes):
            codes = torch.as_tensor(codes, device=dev)
            h = model(qi, qm, codes, deterministic=True)
            d = model.doc_embeds(codes)
            # per-position partial dots so prefix margins reuse the pass
            return (h.float() * d.float()).sum(-1).cpu().numpy()

        return one(pos), one(neg)  # [B, m] each

    return scores


def probe_margin_scale(model: RiporModel, params, tok, queries,
                       examples: TeacherScoreExamples,
                       docid_to_codes: Optional[Dict] = None,
                       prefix_lengths: Sequence[int] = (),
                       n: int = 256, batch_size: int = 64,
                       seed: int = 0) -> Dict[str, float]:
    """Sample ``n`` (pos, neg) pairs exactly as training does, measure the
    student's margins at the current checkpoint against the teacher's, and
    return per-column least-squares alphas plus the raw scale statistics.

    Columns: "alpha" for the full-length scores, "alpha_<p>" for each
    lng_knp prefix column present. Degenerate teachers (Σt² ~ 0) or an
    anti-correlated student (alpha <= 0, where trusting the sign would
    flip the teacher's ordering) fall back to the std ratio.

    ``model``: a RiporModel, scoring in its dtype on its device;
    ``params``: a state_dict loaded into it first, or None."""
    coll = MarginMSECollator(tok, queries, docid_to_codes,
                             smtid_as_docid=examples.smtid_as_docid,
                             prefix_lengths=tuple(prefix_lengths))
    rng = np.random.default_rng(seed)
    samples = [examples.sample_pair(int(rng.integers(len(examples))), rng,
                                    prefix_keys=tuple(prefix_lengths))
               for _ in range(n)]
    fn = _score_fn(model, params)
    s_pos, s_neg = [], []
    for i in range(0, n, batch_size):
        b = coll(samples[i:i + batch_size])
        sp, sn = fn(b["query_ids"], b["query_mask"],
                    b["pos_codes"], b["neg_codes"])
        s_pos.append(np.asarray(sp, np.float64))
        s_neg.append(np.asarray(sn, np.float64))
    s_pos = np.concatenate(s_pos)  # [n, m] per-position dots
    s_neg = np.concatenate(s_neg)

    t_pos = np.asarray([s["pos_score"] for s in samples], np.float64)
    t_neg = np.asarray([s["neg_score"] for s in samples], np.float64)

    def ls_alpha(s: np.ndarray, t: np.ndarray) -> float:
        denom = float(np.dot(t, t))
        if denom < 1e-12:
            return 1.0
        a = float(np.dot(s, t) / denom)
        if a <= 0:
            ts = float(t.std())
            return float(s.std() / ts) if ts > 1e-12 else 1.0
        return a

    s_full = s_pos.sum(-1) - s_neg.sum(-1)
    t_full = t_pos - t_neg
    out = {
        "alpha": ls_alpha(s_full, t_full),
        "student_margin_mean": float(s_full.mean()),
        "student_margin_std": float(s_full.std()),
        "teacher_margin_mean": float(t_full.mean()),
        "teacher_margin_std": float(t_full.std()),
        "n": int(n),
    }
    for p in prefix_lengths:
        sp = s_pos[:, :p].sum(-1) - s_neg[:, :p].sum(-1)
        tp = (np.asarray([s[f"smtid_{p}_pos_score"] for s in samples], np.float64)
              - np.asarray([s[f"smtid_{p}_neg_score"] for s in samples], np.float64))
        out[f"alpha_{p}"] = ls_alpha(sp, tp)
    return out


def calibrate_rows(rows: Sequence[Dict], alphas: Dict[str, float]
                   ) -> Tuple[list, Dict[str, float]]:
    """Scale every score column of teacher-example rows by its alpha.
    Returns (new rows, the column->alpha map actually applied)."""
    applied = {"scores": alphas["alpha"]}
    for k, a in alphas.items():
        if k.startswith("alpha_"):
            applied[f"smtid_{k[6:]}_scores"] = a
    out = []
    for ex in rows:
        new = dict(ex)
        for col, a in applied.items():
            if col in new:
                new[col] = [s * a for s in new[col]]
        out.append(new)
    return out, applied


def calibrate_trainset(path_in: str, path_out: str, model: RiporModel,
                       params, tok, queries,
                       docid_to_codes: Optional[Dict] = None,
                       smtid_as_docid: bool = True,
                       prefix_lengths: Sequence[int] = (),
                       n: int = 256, seed: int = 0,
                       alphas_out: Optional[str] = None) -> Dict[str, float]:
    """Probe ``path_in`` at the current checkpoint and write the
    scale-calibrated trainset to ``path_out`` (+ the alphas JSON next to it
    when ``alphas_out`` is given). Returns the probe stats."""
    examples = TeacherScoreExamples(path_in, smtid_as_docid=smtid_as_docid)
    plens = tuple(p for p in prefix_lengths
                  if f"smtid_{p}_scores" in examples.examples[0])
    stats = probe_margin_scale(model, params, tok, queries, examples,
                               docid_to_codes=docid_to_codes,
                               prefix_lengths=plens, n=n, seed=seed)
    rows, applied = calibrate_rows(examples.examples, stats)
    with open(path_out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    stats["applied"] = applied
    if alphas_out:
        with open(alphas_out, "w") as f:
            json.dump(stats, f, indent=1)
    return stats
