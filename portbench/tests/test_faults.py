"""A run with the timed path broken underneath comes out not correct:
each fault a one-card retrieval cell can have, planted in the program
for the length of one run, at the toy size with the numbers each cell
compares, and on a card at the offline cell's own size and limits.
(There is no exchange between chips to leave out: every cell runs on one
card.)"""
import time

import pytest
import torch

from portbench.tests.toy import run_toy


def state_unchanged(mp):
    """The decode step's cache reorder returns its state as it was: no
    beam's history moves and no new row goes in."""
    import ripor_tpu_torch.models.t5 as t5
    mp.setattr(t5, "reorder_cache_all",
               lambda kvg, cache_src, *a, **k: cache_src)


def half_batch(mp):
    """Half of each batch is searched and its answers stand in for the
    other half."""
    import ripor_tpu_torch.decode.beam as beam
    make = beam.make_beam_search_fn

    def make_half(*a, **k):
        fn = make(*a, **k)

        def run(model, ids, mask, tables):
            B = ids.shape[0]
            h = max(1, B // 2)
            out = fn(model, ids[:h], mask[:h], tables)
            idx = torch.arange(B) % h
            return tuple(x[idx.to(x.device)] for x in out)
        return run
    mp.setattr(beam, "make_beam_search_fn", make_half)


def answer_altered(mp):
    """One document of every answer is another document, where the
    answer is produced."""
    import ripor_tpu_torch.decode.beam as beam
    expand = beam.expand_groups_to_docids

    def altered(trie, groups, scores, topk):
        docs, s = expand(trie, groups, scores, topk)
        docs = docs.copy()
        docs[1] = (docs[1] + 1) % len(trie.group_docids)
        if docs[1] in docs[[0] + list(range(2, len(docs)))]:
            docs[1] = (docs[1] + 7) % len(trie.group_docids)
        return docs, s
    mp.setattr(beam, "expand_groups_to_docids", altered)


def token_altered(mp):
    """Every token the decoder reads back is the next code, not the one
    the step chose."""
    from ripor_tpu_torch.models.ripor import RiporModel
    step_input = RiporModel._step_input

    def altered(self, tokens, t):
        return step_input(self, (tokens + 1) % self.cfg.K, t)
    mp.setattr(RiporModel, "_step_input", altered)


OFFLINE = "t5base-32x256-offline-b1000"
# the toy serve cell's batches mostly hold one request, which has no half
# to leave out; the offline cell's batches are always full. One document
# of an answer altered is below what the int4 offline cell compares (its
# int4 cache moves single scores by a third of the control's error): a
# token altered where it is produced stands for that fault there.
CASES = [(c, f) for c in (OFFLINE, "t5base-32x256-serve-b100")
         for f in (state_unchanged, half_batch, answer_altered, token_altered)
         if not (f is half_batch and "serve" in c)
         and not (f is answer_altered and c == OFFLINE)]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_toy(cell)
    assert not r["correct"]
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in r["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("fault,seed", [
    (state_unchanged, 7100000001), (half_batch, 7100000002),
    (half_batch, 7100000003), (half_batch, 7100000004),
    (token_altered, 7100000005)])
def test_fault_fails_the_offline_cell_on_the_card(fault, seed, monkeypatch):
    """The offline cell as committed (its sizes, its files, its limits),
    a short window on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.run import execute, set_cache_env
    set_cache_env()
    fault(monkeypatch)
    r = execute(OFFLINE, seed, 3.0, False, "cuda",
                t_start=time.perf_counter(), log=lambda *a, **k: None)
    print(fault.__name__, seed, r["checks"])
    assert not r["correct"]
