"""The megarow search's graph sets and CUDA graphs (decode/beam.py,
``graph_set``, ``_Pieces``): a search through a kept set against one
through a set made for the call, bit for bit, on a toy model.

On the CPU a kept set (``_graphs=True``) runs its pieces without capture,
which holds what keeping adds (static buffers reused from search to
search, the keys, the weak references to the model and the tables, the
least recently used set going) to a fresh set's results; the gate's
choice is read from the search function. The ``cuda`` cases capture and
replay on the card against the uncaptured pieces: ``python -m pytest -q
--noconftest -m cuda tests/test_torch_beam_graphs.py`` (no JAX is
imported here)."""
import gc
import weakref

import numpy as np
import pytest
import torch

import ripor_tpu_torch.decode.beam as beam
from ripor_tpu_torch.decode.beam import DECODE_STEPS, make_beam_search_fn
from ripor_tpu_torch.models import RiporModel, init_params, ripor_small
from ripor_tpu_torch.trie import build_trie, succinct_tables, tables_to_torch
from ripor_tpu_torch.trie.succinct import dummy_tables

# M=8 over the default four cache segments: spans of 2, the megarow path
M, K, BEAMS, DOCS, S = 8, 16, 16, 300, 12
CFG = ripor_small(M=M, K=K)

CASES = {
    "exact": dict(),
    "int8": dict(kv_cache_quant="int8"),
    "int4": dict(kv_cache_quant="int4"),
    "int4 qfuse off": dict(kv_cache_quant="int4", qfuse=False),
    "int8 kvg quantized in torch": dict(kv_cache_quant="int8", qfuse=False,
                                        kvg_quant_xla=True),
    "int4 fused kvg": dict(kv_cache_quant="int4", fused_kvg=True),
    "exact fused kvg": dict(fused_kvg=True),
    "int4 mxu math": dict(kv_cache_quant="int4", mxu_math=True),
    "int8 ffn_int8": dict(kv_cache_quant="int8", ffn_int8=True),
    "unconstrained": dict(constrained=False),
}


def _model(device, seed=0, dtype=torch.float32):
    model = RiporModel(CFG, dtype=dtype, device=device)
    model.load_state_dict(init_params(
        CFG, torch.Generator(device).manual_seed(seed), device=device,
        dtype=dtype))
    return model


def _tables(device, seed=0, constrained=True):
    if not constrained:
        return tables_to_torch(dummy_tables(M), device)
    codes = np.random.default_rng(seed).integers(0, K, (DOCS, M))
    return tables_to_torch(succinct_tables(build_trie(codes, K)), device)


def _queries(B, seed):
    rng = np.random.default_rng(100 + seed)
    ids = rng.integers(3, CFG.t5.vocab_size, (B, S)).astype(np.int32)
    mask = np.ones_like(ids)
    for b in range(B):                  # padded queries, as the tokenizer's
        mask[b, S - b:] = 0
    return ids * mask, mask


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _pair(device, kw, dtype=torch.float32):
    """A search that keeps no set (its pieces uncaptured) and one that
    keeps them, built alike."""
    kw = dict(kw, dtype=dtype, device=device)
    return (make_beam_search_fn(CFG, BEAMS, _graphs=False, **kw),
            make_beam_search_fn(CFG, BEAMS, _graphs=True, **kw))


# ---------------------------------------------------------------------------
# CPU: the kept sets and the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_loop_equals_eager_cpu(case, B):
    kw = CASES[case]
    model = _model("cpu")
    tables = _tables("cpu", constrained=kw.get("constrained", True))
    eager, graphed = _pair("cpu", kw)
    for seed in (0, 1):                 # the first call builds the set
        ids, mask = _queries(B, seed)
        assert _equal(graphed(model, ids, mask, tables),
                      eager(model, ids, mask, tables)), (case, seed)


def test_results_do_not_alias_the_buffers_cpu():
    model, tables = _model("cpu"), _tables("cpu")
    eager, graphed = _pair("cpu", CASES["int4"])
    first = graphed(model, *_queries(2, 0), tables)
    kept = [x.clone() for x in first]
    graphed(model, *_queries(2, 1), tables)
    assert _equal(first, kept)
    assert _equal(first, eager(model, *_queries(2, 0), tables))


def test_another_model_or_trie_gets_its_own_set_cpu():
    tables, other_tables = _tables("cpu"), _tables("cpu", seed=1)
    model, other = _model("cpu"), _model("cpu", seed=1)
    eager, graphed = _pair("cpu", CASES["int4"])
    ids, mask = _queries(2, 0)
    before = DECODE_STEPS["captures"]
    for m, t in ((model, tables), (other, tables), (model, other_tables),
                 (model, tables)):
        assert _equal(graphed(m, ids, mask, t), eager(m, ids, mask, t))
    assert DECODE_STEPS["captures"] - before == 3


def test_patched_model_searches_eagerly_cpu():
    """Graphs hold the code that ran at their capture: a model whose
    output projections split_sums patches (or any hooked module) takes
    the eager loop, and the plain model its graphs again after."""
    from ripor_tpu_torch.parallel import split_sums
    model, tables = _model("cpu"), _tables("cpu")
    eager, graphed = _pair("cpu", CASES["exact"])
    ids, mask = _queries(2, 0)
    graphed(model, ids, mask, tables)
    before = dict(DECODE_STEPS)
    with split_sums(model):
        got = graphed(model, ids, mask, tables)
        want = eager(model, ids, mask, tables)
    assert _equal(got, want)
    assert DECODE_STEPS["eager_steps"] - before["eager_steps"] == 2 * M
    assert DECODE_STEPS["graphed_steps"] == before["graphed_steps"]
    hook = model.decoder.layers[0].ffn.register_forward_hook(
        lambda *a: None)
    graphed(model, ids, mask, tables)
    hook.remove()
    assert DECODE_STEPS["eager_steps"] - before["eager_steps"] == 3 * M
    assert _equal(graphed(model, ids, mask, tables),
                  eager(model, ids, mask, tables))
    assert DECODE_STEPS["graphed_steps"] - before["graphed_steps"] == M
    assert DECODE_STEPS["captures"] == before["captures"]


def test_least_recently_used_set_goes_cpu(monkeypatch):
    monkeypatch.setattr(beam, "GRAPH_SETS", 2)
    model, tables = _model("cpu"), _tables("cpu")
    _, graphed = _pair("cpu", CASES["exact"])
    before = DECODE_STEPS["captures"]
    for B in (1, 2, 1, 3, 1, 2):        # 2 went when 3 came
        graphed(model, *_queries(B, 0), tables)
    assert DECODE_STEPS["captures"] - before == 4


def test_counter_cpu():
    model, tables = _model("cpu"), _tables("cpu")
    eager, graphed = _pair("cpu", CASES["int4"])
    before = dict(DECODE_STEPS)
    for seed in range(3):
        graphed(model, *_queries(2, seed), tables)
    eager(model, *_queries(2, 0), tables)
    assert {k: DECODE_STEPS[k] - before[k] for k in before} == {
        "captures": 1, "graphed_steps": 3 * M, "eager_steps": M}


def test_step_bias_tables_equal_step_biases_cpu():
    """The megarow search takes every step's K2 biases from one table
    (Decoder.step_bias_tables); each row equals the per-step biases that
    the other paths build, at every cache length of every step."""
    dec = _model("cpu").decoder
    full = dec.full_self_bias(M)
    hist, new = dec.step_bias_tables(full)
    for t in range(M):
        for mc in range(t + 1, M + 1):
            want_hist, want_new = dec._step_biases(full, t, mc)
            assert torch.equal(hist[t, :mc], want_hist), (t, mc)
            assert torch.equal(new[t], want_new), t


PATHS = {
    "megarow": dict(),
    "deferred": dict(megarow=False),
    "non-deferred": dict(deferred=False),
    "write-then-attend": dict(use_pallas_gather=False),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_gate_reads_the_path_and_the_device(path, monkeypatch):
    """Graphs engage on the megarow path on a card, outside tensor
    parallelism, and nowhere else (the function is only built: building
    it touches no device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tp_cfg = ripor_small(M=M, K=K)
    tp_cfg = type(tp_cfg)(**{**tp_cfg.__dict__, "t5": type(tp_cfg.t5)(
        **{**tp_cfg.t5.__dict__, "tp_axis": "model"})})
    for cfg, device, want in ((CFG, "cuda", path == "megarow"),
                              (CFG, "cpu", False),
                              (tp_cfg, "cuda", False)):
        fn = make_beam_search_fn(cfg, BEAMS, device=device, **PATHS[path])
        assert fn.graphed is want, (path, device, cfg.t5.tp_axis)


def test_eager_paths_count_eager_steps_cpu():
    model, tables = _model("cpu"), _tables("cpu")
    ids, mask = _queries(2, 0)
    for kw in PATHS.values():
        before = dict(DECODE_STEPS)
        make_beam_search_fn(CFG, BEAMS, dtype=torch.float32, device="cpu",
                            **kw)(model, ids, mask, tables)
        assert DECODE_STEPS["eager_steps"] - before["eager_steps"] == M
        assert DECODE_STEPS["graphed_steps"] == before["graphed_steps"]


def test_engine_stats_show_the_steps_cpu():
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    codes = np.random.default_rng(0).integers(0, K, (DOCS, M))
    engine = RetrievalEngine(
        CFG, init_params(CFG, torch.Generator().manual_seed(0)),
        HashTokenizer(CFG.t5.vocab_size), build_trie(codes, K),
        [str(i) for i in range(DOCS)],
        ServeConfig(num_beams=4, topk=4, max_length=8, batch_sizes=(2,)),
        warm=False, device="cpu")
    before = dict(DECODE_STEPS)
    engine.retrieve_batch(["a query", "another"])
    stats = engine.stats()
    assert stats["decode_steps"]["eager_steps"] - before["eager_steps"] == M
    assert stats["served"] == 2 and stats["batch_hist"] == {2: 1}


def test_graphed_loop_refuses_other_paths():
    with pytest.raises(ValueError, match="megarow"):
        make_beam_search_fn(CFG, BEAMS, megarow=False, device="cpu",
                            _graphs=True)


# ---------------------------------------------------------------------------
# On the card: capture and replay
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphs_equal_eager(card, case, B, dtype):
    kw = CASES[case]
    model = _model(card, dtype=dtype)
    tables = _tables(card, constrained=kw.get("constrained", True))
    eager = make_beam_search_fn(CFG, BEAMS, _graphs=False, dtype=dtype,
                                device=card, **kw)
    graphed = make_beam_search_fn(CFG, BEAMS, dtype=dtype, device=card,
                                  **kw)
    assert graphed.graphed
    for seed in (0, 1, 2):              # capture, then replays
        ids, mask = _queries(B, seed)
        assert _equal(graphed(model, ids, mask, tables),
                      eager(model, ids, mask, tables)), (case, seed)


@pytest.mark.cuda
def test_two_in_flight(card):
    model, tables = _model(card, dtype=torch.bfloat16), _tables(card)
    kw = dict(kv_cache_quant="int4", dtype=torch.bfloat16, device=card)
    eager = make_beam_search_fn(CFG, BEAMS, _graphs=False, **kw)
    graphed = make_beam_search_fn(CFG, BEAMS, **kw)
    graphed(model, *_queries(4, 9), tables)            # the capture
    a = graphed(model, *_queries(4, 0), tables)
    b = graphed(model, *_queries(4, 1), tables)        # before a is read
    assert _equal([x.cpu() for x in a],
                  [x.cpu() for x in eager(model, *_queries(4, 0), tables)])
    assert _equal([x.cpu() for x in b],
                  [x.cpu() for x in eager(model, *_queries(4, 1), tables)])


@pytest.mark.cuda
def test_another_model_or_trie(card):
    kw = dict(kv_cache_quant="int4", dtype=torch.bfloat16, device=card)
    eager = make_beam_search_fn(CFG, BEAMS, _graphs=False, **kw)
    graphed = make_beam_search_fn(CFG, BEAMS, **kw)
    model = _model(card, dtype=torch.bfloat16)
    tables = _tables(card)
    ids, mask = _queries(2, 0)
    before = DECODE_STEPS["captures"]
    assert _equal(graphed(model, ids, mask, tables),
                  eager(model, ids, mask, tables))
    other, other_tables = _model(card, 1, torch.bfloat16), _tables(card, 1)
    for m, t in ((other, tables), (model, other_tables), (model, tables)):
        assert _equal(graphed(m, ids, mask, t), eager(m, ids, mask, t))
    assert DECODE_STEPS["captures"] - before == 3
    # a model freed and another made: never the freed one's graphs
    gone = weakref.ref(other)
    del other
    assert gone() is None
    fresh = _model(card, 2, torch.bfloat16)
    before = DECODE_STEPS["captures"]
    assert _equal(graphed(fresh, ids, mask, tables),
                  eager(fresh, ids, mask, tables))
    assert DECODE_STEPS["captures"] - before == 1


@pytest.mark.cuda
def test_counter_on_the_card(card):
    model, tables = _model(card, dtype=torch.bfloat16), _tables(card)
    graphed = make_beam_search_fn(CFG, BEAMS, kv_cache_quant="int4",
                                  dtype=torch.bfloat16, device=card)
    before = dict(DECODE_STEPS)
    for B in (2, 4, 2, 4, 2):
        graphed(model, *_queries(B, 0), tables)
    assert {k: DECODE_STEPS[k] - before[k] for k in before} == {
        "captures": 2, "graphed_steps": 5 * M, "eager_steps": 0}


@pytest.mark.parametrize("failing", ["prologue", ("tail", 3)])
def test_failed_capture_raises_and_drops_the_set_cpu(failing, monkeypatch):
    """A piece that fails in its capture fails the search, and its set is
    not kept: the next search builds a new one, with the right results."""
    calls = {"n": 0}
    orig = beam._Pieces.__call__

    def failing_once(self, name, fn, *args):
        if name == failing and calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("capture of a test piece")
        orig(self, name, fn, *args)

    monkeypatch.setattr(beam._Pieces, "__call__", failing_once)
    model, tables = _model("cpu"), _tables("cpu")
    eager, graphed = _pair("cpu", CASES["int4"])
    before = dict(DECODE_STEPS)
    with pytest.raises(RuntimeError, match="capture of a test piece"):
        graphed(model, *_queries(2, 0), tables)
    for seed in (0, 1):
        assert _equal(graphed(model, *_queries(2, seed), tables),
                      eager(model, *_queries(2, seed), tables))
    assert DECODE_STEPS["captures"] - before["captures"] == 2


def test_kept_sets_hold_neither_model_nor_tables_cpu():
    """A kept set refers to its model and tables weakly, and the search
    function to nothing that refers back to it: with the cyclic collector
    off, each goes when its last reference does. A set whose model went
    is not used again: a new model captures anew."""
    gc.disable()
    try:
        model, tables = _model("cpu"), _tables("cpu")
        eager, graphed = _pair("cpu", CASES["int4"])
        ids, mask = _queries(2, 0)
        graphed(model, ids, mask, tables)
        refs = [weakref.ref(x) for x in (model, tables[0])]
        del model, tables
        assert [r() for r in refs] == [None, None]
        before = DECODE_STEPS["captures"]
        fresh, tables = _model("cpu", seed=2), _tables("cpu")
        assert _equal(graphed(fresh, ids, mask, tables),
                      eager(fresh, ids, mask, tables))
        assert DECODE_STEPS["captures"] - before == 1
        ref = weakref.ref(graphed)
        del graphed
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.cuda
def test_evicted_sets_capture_again(card, monkeypatch):
    monkeypatch.setattr(beam, "GRAPH_SETS", 1)
    model, tables = _model(card, dtype=torch.bfloat16), _tables(card)
    kw = dict(kv_cache_quant="int4", dtype=torch.bfloat16, device=card)
    eager = make_beam_search_fn(CFG, BEAMS, _graphs=False, **kw)
    graphed = make_beam_search_fn(CFG, BEAMS, **kw)
    before = DECODE_STEPS["captures"]
    for B, seed in ((2, 0), (4, 1), (2, 2), (2, 3)):
        ids, mask = _queries(B, seed)
        assert _equal(graphed(model, ids, mask, tables),
                      eager(model, ids, mask, tables)), (B, seed)
    assert DECODE_STEPS["captures"] - before == 3


@pytest.mark.cuda
def test_patched_model_on_the_card(card):
    from ripor_tpu_torch.parallel import split_sums
    model, tables = _model(card, dtype=torch.bfloat16), _tables(card)
    kw = dict(dtype=torch.bfloat16, device=card)
    eager = make_beam_search_fn(CFG, BEAMS, _graphs=False, **kw)
    graphed = make_beam_search_fn(CFG, BEAMS, **kw)
    ids, mask = _queries(2, 0)
    graphed(model, ids, mask, tables)                   # the capture
    with split_sums(model):
        assert _equal(graphed(model, ids, mask, tables),
                      eager(model, ids, mask, tables))
    assert _equal(graphed(model, ids, mask, tables),
                  eager(model, ids, mask, tables))
