"""The plain reference against the program (ripor_tpu_torch) on the CPU
at ripor_small's widths: the same scores on the same beams. Only the test
imports both; the reference imports nothing of the program."""
import numpy as np
import pytest
import torch

from portbench import world
from portbench.reference import Reference, query_ids
from portbench.tests.toy import TOY_MODEL


def search(dtype, quant, seed=3):
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.models.ripor import RiporModel
    from ripor_tpu_torch.trie import build_trie, succinct_tables, \
        tables_to_torch
    d = dict(TOY_MODEL, M=8, K=16)
    cfg = world.program_config(d)
    weights = world.make_weights(cfg, d, seed, "cpu", torch.float32)
    weights = {k: v.to(dtype) if not k.endswith(".scale") else v
               for k, v in weights.items()}
    codes = world.make_codes({"docs": 400, "narrow_levels": 2}, d, seed)
    model = RiporModel(cfg, dtype=dtype)
    model.load_state_dict(weights)
    fn = make_beam_search_fn(cfg, 20, dtype=dtype, device="cpu",
                             kv_cache_quant=quant)
    ids = torch.tensor([[5, 9, 33, 1, 0, 0], [7, 8, 1, 0, 0, 0]])
    tables = tables_to_torch(succinct_tables(build_trie(codes, 16)), "cpu")
    scores, paths, _ = fn(model, ids, (ids > 0).int(), tables)
    return d, weights, ids, scores, paths


def ref_scores(ref, ids, paths):
    encs = [ref.encode(ids[b, :int((ids[b] > 0).sum())]) for b in range(2)]
    return encs, ref.path_scores(encs, [paths[0], paths[1]])


@pytest.mark.parametrize("dtype,quant,precision,tol", [
    (torch.float32, None, "float32", 1e-4),     # the same sums in f32
    (torch.float32, "int8", "float32", 0.15),   # int8 rows' products in bf16
    (torch.bfloat16, None, "bfloat16", 1.0),
    (torch.bfloat16, "int4", "bfloat16", 1.5),
])
def test_reference_scores_the_programs_beams(dtype, quant, precision, tol):
    d, weights, ids, scores, paths = search(dtype, quant)
    ref = Reference(weights, d, "cpu", precision=precision, cache=quant)
    _, got = ref_scores(ref, ids, paths)
    for b in range(2):
        assert (got[b] - scores[b].double()).abs().max() < tol


def test_reference_search_finds_the_programs_beams():
    """float32 and an exact cache: the same documents, scores to 1e-4."""
    from portbench.reference.trie import PrefixRuns
    d, weights, ids, scores, paths = search(torch.float32, None)
    codes = world.make_codes({"docs": 400, "narrow_levels": 2}, d, 3)
    ref = Reference(weights, d, "cpu")
    encs, _ = ref_scores(ref, ids, paths)
    found = ref.search(encs, PrefixRuns(codes, d["K"]), 20, 20)
    for b in range(2):
        want = {tuple(p) for p in paths[b].tolist()}
        assert {tuple(codes[x]) for x in found[b]} == want


def test_float8_control_departs():
    d, weights, ids, scores, paths = search(torch.float32, None)
    _, a = ref_scores(Reference(weights, d, "cpu"), ids, paths)
    _, b = ref_scores(Reference(weights, d, "cpu", precision="float8"),
                      ids, paths)
    assert (a[0] - b[0]).abs().median() > 0.3


def test_prefix_runs():
    from portbench.reference.trie import PrefixRuns
    codes = np.array([[1, 0, 2], [0, 1, 1], [0, 1, 0], [0, 0, 3],
                      [1, 0, 2]])
    runs = PrefixRuns(codes, 4)
    assert runs.codes.tolist() == sorted(codes.tolist())
    parent, code, lo, hi = runs.children(np.array([0]), np.array([5]), 0)
    assert code.tolist() == [0, 1] and (hi - lo).tolist() == [3, 2]
    parent, code, lo, hi = runs.children(lo, hi, 1)
    assert parent.tolist() == [0, 0, 1] and code.tolist() == [0, 1, 0]
    assert sorted(runs.documents(lo[2], hi[2]).tolist()) == [0, 4]


def test_query_ids_are_the_tokenizers():
    from ripor_tpu_torch.data.tokenizer import HashTokenizer, \
        tokenize_queries
    texts = ["w1 w22 w333", " W4  w5 ", "w" + " w".join(map(str, range(90)))]
    ids, mask = tokenize_queries(HashTokenizer(32128), texts, 64)
    for i, t in enumerate(texts):
        want = query_ids(t, 32128, 64)
        assert ids[i, :len(want)].tolist() == want
        assert int(mask[i].sum()) == len(want)


def test_history_rounding_is_the_cache_codec():
    from ripor_tpu_torch.ops.attend_reorder import (
        decode_rows, quantize_rows_int4_plain, quantize_rows_plain)
    from portbench.reference.t5 import history_rounding
    x = torch.randn(50, 2 * 64, generator=torch.Generator().manual_seed(0))
    for quant, enc in (("int8", quantize_rows_plain),
                       ("int4", quantize_rows_int4_plain)):
        k, v, ek, ev = decode_rows(enc(x, 4), 64, 4, quant)
        got = torch.cat([(k.float().view(50, 4, 16) * ek[..., None]),
                         (v.float().view(50, 4, 16) * ev[..., None])], 1)
        want = torch.cat([history_rounding(x[:, :64], 4, quant),
                          history_rounding(x[:, 64:], 4, quant)], 1)
        assert torch.equal(got.reshape(50, 128), want)
