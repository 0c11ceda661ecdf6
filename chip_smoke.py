#!/usr/bin/env python3
"""Drive the PyTorch port (ripor_tpu_torch) on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, top to bottom; any failed check raises, so the exit code is
nonzero and no result line is printed:

  1. build the hand-written CUDA kernels from ripor_tpu_torch/csrc/, and
     print ptxas's registers, stack and spill bytes of the staged kernels
     K2, K4, K5 and K8;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (t5-base widths, B=8, N=1000, L=12, Mc in
     {8, 32}; the staged kernels at every segment size, Mc in {8, 16, 24,
     32}, with their launch plans): K1-K3 with exact bf16, int8 and int4
     rows; the megarow dataflows' bodies (dataflow_checks): K1' (exact
     rows quantized on insert) into int8 and int4 caches at Mc 8 and 32,
     t = 0 and Mc/2, K1'' (kvg through src) in its verbatim int8,
     quantize-on-insert and exact bf16 forms, bit-equal, and K2'
     (mxu_math) on int8 and int4 rows at every segment size; K4 with
     int4, int8 (exact and pre-quantized kvg rows) and bf16
     rows; K5 in bf16 (and f32 at Mc=32) and K6 in bf16; K8 in bf16 and
     f32 at two slots t; K7 in bf16, int8 and on narrow blocks; then the
     slabs no stage holds (slot chunks, one layer): K2 and K4 at t5-3b
     widths in bf16 and int8 rows and at t5-large in f32, K5 and K8 at
     t5-large in f32 and t5-3b in bf16; then the kernels of phase 11's
     searches at their own shapes (pipeline_searches: B 4 and 8, beam 8,
     10 and 100, t5-base and the recipe's small model), at every step t
     with its cache of Mc slots: K1-K3 on the megarow path, K5, K3, K6 on
     the non-deferred path of the prefix-4 searches; each of K1-K8 at
     the per-rank width of 2-way tensor parallelism at t5-base (H=6,
     F=384; tp_width_checks, K1-K3 at every segment); and the kernels of
     phase 12's searches the same way as phase 11's (mesh_searches: DP
     at B=4 and t5-base width, TP at H=6 / F=384 and B=8 in bf16 on
     int4 rows and in f32 on exact rows, and the toy TP searches). Time
     kernel, plain version and one PyTorch call of the same function
     where there is one (advanced indexing for the gathers,
     scaled_dot_product_attention for K5 and K8): a yardstick the port
     never uses;
  3. agreement on a small input: the port's beam search through the
     kernels on the card against its plain path on the CPU (the path the
     CPU tests hold against the JAX package), on the megarow and deferred
     paths (exact, int8, int4 caches; on the megarow path also the
     dataflows qfuse=False, kvg_quant_xla, fused_kvg and mxu_math), the
     non-deferred path and the write-then-attend path;
  4. the main path: RetrievalEngine at ripor_base(M=32, K=256) with random
     bf16 weights from a seed, a 100,000-doc random-code corpus, beam =
     topk = 1000, on the megarow path with int4, exact bf16 and int8
     caches; launch counters are zeroed just before and read just after,
     and each megarow kernel (K1-K3) must have launched;
  5. inside phase 4's int4 run, one B=8 decode under torch.profiler:
     device time by kernel and the device's busy share of the wall time;
  6. the deferred per-layer path (make_beam_search_fn(..., megarow=False);
     int4, int8 and bf16 caches), the non-deferred path (deferred=False;
     bf16) and the write-then-attend path (use_pallas_gather=False; bf16)
     at phase 4's model, corpus and queries: one
     B=8 search each, after one warm-up search, with phase 4's checks and
     launch counters zeroed just before and read just after; two more
     searches for the time (median of three), and the same profile as
     phase 5. 6b: the megarow dataflows at phase 4's int4 search
     (qfuse=False: K1' 32, K2 384, K3 31; fused_kvg=True, alone and with
     qfuse=False: K1'' 32, K2 384; mxu_math=True: K1 32, K2' 384, K3 31),
     one B=8 search each after a warm-up, with phase 4's checks; K1' and
     K1'' equal phase 4's search bit for bit, K2' reports the codes it
     moves;
  7. the main path through its entry points, at phase 4's model and
     corpus: a workspace written by the port's own functions (save_params,
     docid_to_smtid.json, a WordTokenizer, 16 queries); the ``retrieve``
     CLI at beam = topk = 1000 as a subprocess and in process, its run.json
     equal to RetrievalEngine.retrieve_batch, with queries per second and
     the load and trie seconds; ``--nranks 2`` + ``retrieve-merge`` equal to
     the single run; ``evaluate`` printing exactly the MRR@10 of a
     constructed qrel; ``serve_http`` with an int4 cache answering two POST
     /retrieve as retrieve_batch does, GET /stats, a disabled /profile
     (403); and ffn_int8 on the megarow and deferred paths: at the JAX
     package's bar (tests/test_beam.py:646-672) at that test's geometry,
     and one search each at full width, beside the exact path. Counters
     are zeroed before each part and read after it;
  8. training at full t5-base width and depth (ripor_base(M=32, K=256),
     float32 params and compute, TF32 off, dropout 0.1), loss
     lng_knp_margin_mse, which launches none of the kernels above: one
     step with dropout off on the card and on the CPU from the same params
     (losses, grad_norm and updated params agree); Trainer.run at B=16
     from MarginMSECollator over a synthetic trainset (ms a step,
     examples/s, tokens/s, MFU against the float32 peak, peak memory,
     the busy share of one profiled step), and with grad_accum=2 on
     2 x 8; 4 steps against 2 + a checkpoint + a new Trainer + 2; and
     ``train --config`` as a subprocess on phase 7's workspace, whose
     checkpoint ``retrieve`` then serves with phase 7's checks;
  9. the DocID build and dense retrieval, which launch no new kernel:
     (a) train_rq(M=32, K=256, 25 iterations) on 1,000,000 x 768 rows
     made on the card and rq_encode with beam 4 (MSE falling at every
     stage, one stage against the CPU route), and the streamed route on
     2,000,000 host rows at M=2; (b) DenseEngine over an 8,841,823 x 768
     corpus (MS MARCO's size) in bf16 and as an Int8Corpus, batches of 1,
     8 and 64 at topk 1000, held on a 1,000,000-row slice against a plain
     f32 reference, timed beside the corpus-bytes bound; (c) the CLI on a
     100,000-doc workspace: index --nranks 2, merge-embs, aq-index,
     dense-retrieve (host blocks, device corpus, int8), evaluate,
     hnsw-index + --ann hnsw, serve_http over a DenseEngine, then the
     aq-index codebooks installed and ``retrieve`` over the RQ-built trie
     and dev_eval's unconstrained search, each of which must launch K1-K3
     (counters zeroed just before, read just after); (d) run_e2e at
     tests/test_pipeline.py::test_e2e_slice's geometry (mrr_10 > 0.5);
 10. the teacher and the baselines, in float32 with TF32 off, which
     launch none of the kernels above: (a) BertCrossEncoder at MiniLM-L6
     (64 pairs x 256), BertDenseEncoder at bert-base, T5DenseEncoder at
     t5-base and T5SeqCrossEncoder at ripor_base(M=32, K=256), card
     against CPU from the same seeded params (|diff| <= 1e-4 * max(1,
     |x|)); (b) load_bert_teacher from params.pt + bert_geometry.json and
     rerank_pairs over 64 queries x 100 candidates at max_length 256 in
     batches of 64 and 512 (pairs/s, device ms a batch beside the f32
     FLOP bound, the host's share, the busy share of one profiled batch);
     (c) one step each of bert_bce, t5seq_bce, margin_mse and kldiv on the
     card and the CPU (phase 8's bars), and Trainer.run of each on the
     card at its full batch (bert_bce B=32: ms a step, examples/s, MFU;
     the T5 families B=16); (d) on phase 7's workspace, as
     processes: ``train --config`` bert_bce, ``rerank`` (equal to
     rerank_pairs in process), ``rerank-task`` on two ranks at once +
     ``rerank-task-merge`` (equal to one rank), and the RIPOR self-rerank
     task + merge (equal to rerank_query_smtids);
 11. the pipeline, whose beam searches launch K1-K3 (megarow) and, at
     prefix 4, K5, K3, K6 (non-deferred): (a) datagen_round in process
     on phase 7's workspace over phase 10's teacher trainset (16 queries
     x 100 docids), beam 100, prefix lengths 4/8/16/32, with the self
     teacher and phase 10's BERT teacher (a text for each of the 100,000
     docs); (b) run_full_recipe at
     ripor_base(M=32, K=256) with a MiniLM-L6 teacher on
     tests/test_full_recipe.py's corpus at 2,048 docs and 64 queries,
     every epoch count 1, beam = topk = 100, curriculum 4/8/16/32,
     teacher-scale calibration, prefix_eval (4, 8) and the teacher-margin
     gate open (one teacher epoch leaves the margin at rounding level):
     its artifacts,
     checkpoints and finite metrics, and the seconds of each stage; (c) ``full-recipe`` as a process at
     tests/test_full_recipe.py::RECIPE_KW on its 24-doc corpus, which
     must reach that test's floors; (d) ``pipeline`` over phase 7's
     workspace (retrieve at beam 1000 -> evaluate -> datagen), resumed,
     re-run from a stage, and equal to the subcommands run directly. The
     counters are zeroed just before (a)'s in-process rounds and (b)'s
     run and read just after, and must equal the launches of the
     searches that phase 2 checked (decode_launches);
 12. the mesh: two gloo ranks that share the card, each a process of its
     own (``chip_smoke.py --mesh-rank R 2 DIR``) under a timeout, at
     phase 4's model, corpus and queries (B=8, beam 1000, int4 cache):
     (a) make_sharded_beam_search_fn at data=2 and (b)
     make_tp_beam_search_fn at model=2 (K1-K3 at H=6), each once to warm
     up and once timed with the counters zeroed just before and read
     just after (each rank's launches must equal decode_launches'), (b)
     once more in f32 on an exact cache, counted the same way, the
     all-reduces of one TP step timed alone, and (b) at
     tests/test_sharded_decode.py's geometry in f32 (exact and int4
     megarow); (c) RetrievalEngine(mesh=) and dense_topk(mesh=) over
     1,000,000 x 768 bf16 rows at data=2. Every rank's results must be
     equal and agree with one process's runs at the int4 bar (top beam
     equal, code sets differing by at most one, scores within rtol 0.05 /
     atol 0.25): (a), the engine and f32 (b) with the plain search, bf16
     (b) with a search whose output projections take the same two
     partial sums (parallel/reference.py::split_sums; the plain search's
     movement is reported), the toy TP searches at that test's bars;
     dense_topk's sets apart from ties. Phase 2 holds every kernel launch
     of these searches at its shape (mesh_searches). Then, in the same
     ranks: (d) the engine served on the mesh: both ranks start() it,
     rank 0 serves HTTP on loopback (phase 4's 8 queries one by one and
     as one batch) and submit, its answers equal to retrieve_batch on the
     mesh, then both stop(), counted as (a); (e) data-parallel training at
     data=2 and full t5-base width (f32, lng_knp_margin_mse, phase 8's
     trainset, global B=16): one step at dropout 0 against this process's
     one-process Trainer on the same batch, then 2 warm-up and 3 timed
     steps replicated and with ZeRO (shard_opt_state): ZeRO's params
     bit-equal to replicated, every rank's params equal, each rank's Adam
     moments half of replicated; ms a step, the collectives' ms and peak
     memory a rank. (Two ranks time-share the card and their collectives
     go through host copies: the times say nothing of two cards.)

Prints the card's name and power limit (nvidia-smi), per-phase lines (and
``phase_s``, the seconds of each part of phases 2 to 6b), then a
``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits nonzero
without one, and outside a checkout of the repository.
"""
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM float32 outside tensor cores
B, N, L, F, H = 8, 1000, 12, 768, 12
M, K = 32, 256
SEGMENTS = (8, 16, 24, 32)       # cache slots of cache_segments=4 at M=32
N_DOCS = 100_000
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def random_rows(quant, lead, g, width=(F, H), dtype=None):
    """Valid cache rows [*lead, RW] at width (F, H): random exact rows
    (bf16 unless ``dtype``), or random int8/int4 payload bytes with
    per-head exponents in [-6, -1]."""
    import torch
    from ripor_tpu_torch.ops import SCALE_COLS
    F, H = width
    if quant is None:
        return torch.randn(*lead, 2 * F, generator=g, device="cuda",
                           dtype=dtype or torch.bfloat16)
    payload = 2 * F if quant == "int8" else F
    c = torch.randint(-128, 128, (*lead, payload + SCALE_COLS),
                      generator=g, device="cuda", dtype=torch.int8)
    c[..., payload:payload + 2 * H] = torch.randint(
        -6, 0, (*lead, 2 * H), generator=g, device="cuda",
        dtype=torch.int8)
    c[..., payload + 2 * H:] = 0
    return c


def unique_sources(src):
    """Distinct source rows per batch row: the slabs a gather must read."""
    import torch
    return sum(int(torch.unique(src[b]).numel()) for b in range(B))


def attention_inputs(Mc, t, g, width=(F, H), dtype=None):
    """q [B, N, F], kv_new [B, N, 2F] (bf16 unless ``dtype``) and the
    biases of step t (slots >= t masked), at width (F, H)."""
    import torch
    F, H = width
    dtype = dtype or torch.bfloat16
    q = torch.randn(B, N, F, generator=g, device="cuda", dtype=dtype)
    kv_new = torch.randn(B, N, 2 * F, generator=g, device="cuda",
                         dtype=dtype)
    bias_hist = torch.randn(Mc, H, generator=g, device="cuda")
    bias_hist[t:] = -1e30
    bias_new = torch.randn(1, H, generator=g, device="cuda")
    return q, kv_new, bias_hist, bias_new


def ptxas_report(build_dir, kernels):
    """Phase 1: registers, stack and spill bytes that ptxas reported in
    build.log for each instance of the named kernels (their shared memory
    is dynamic: the launch plan, in phase 2's records)."""
    import re
    from pathlib import Path
    recs, cur = [], None
    for line in (Path(build_dir) / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            hit = next((k for k in kernels if f"{k}_kernel" in name), None)
            cur = None
            if hit:
                inst = name.split(f"{hit}_kernel", 1)[1].split("EEv", 1)[0]
                cur = {"kernel": hit, "instance": inst}
                recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return recs


def megarow_checks(results, g):
    """Phase 2, megarow kernels K1-K3 against their plain versions at the
    main path's shapes; appends (kernel, case, record) to results."""
    import torch
    for Mc in SEGMENTS:
        for quant in ("int4", "int8", None):
            n_before = len(results)
            megarow_case(results, f"{quant or 'bf16'} Mc={Mc}", quant, Mc, g,
                         ends=Mc in (SEGMENTS[0], SEGMENTS[-1]))
            torch.cuda.empty_cache()
            print_checks(results[n_before:])


def megarow_case(results, tag, quant, Mc, g, ends=True, width=(F, H)):
    """K2 at t = Mc - 1 of a [B, N, L, Mc, RW] cache at ``width``, and
    with ``ends`` K1 and K3 (bit-equal), against their plain versions."""
    import torch
    from ripor_tpu_torch.ops import (beam_gather_rows,
                                     beam_gather_rows_plain,
                                     reorder_cache_all,
                                     reorder_cache_all_plain)
    bidx = torch.arange(B, device="cuda")[:, None]
    cache = random_rows(quant, (B, N, L, Mc), g, width)
    RW = cache.shape[-1]
    src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                        dtype=torch.int32)
    uniq = unique_sources(src)
    slab = L * Mc * RW * cache.element_size()
    t = Mc - 1
    if ends:
        # K1
        kvg = (torch.randint(-128, 128, (B, N, L * RW), generator=g,
                             device="cuda", dtype=torch.int8)
               if quant else
               torch.randn(B, N, L * RW, generator=g, device="cuda",
                           dtype=torch.bfloat16))
        dst = torch.empty_like(cache)
        ref = reorder_cache_all_plain(
            kvg, cache, torch.empty_like(cache), src, t)
        out = reorder_cache_all(kvg, cache, dst, src, t)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"reorder_cache_all {tag}")
        del ref
        rec = dict(
            ms=cuda_ms(lambda: reorder_cache_all(
                kvg, cache, dst, src, t), 5),
            plain_ms=cuda_ms(lambda: reorder_cache_all_plain(
                kvg, cache, dst, src, t), 3),
            library_ms=cuda_ms(lambda: cache[bidx, src.long()], 3),
            max_abs_err=0.0)
        rec["bound_ms"], rec["bound_by"] = bound(
            uniq * slab + B * N * slab + nbytes(kvg, src))
        results.append(("reorder_cache_all", tag, rec))
        del dst, kvg

    step_attention_seq_case(results, tag, quant, cache, Mc, t, g,
                            width=width)
    if ends:
        # K3 over this step's rows in the layout the main path gathers
        # (QFUSE int8 rows, or exact bf16 K|V rows)
        x = cache[:, :, :, 0].reshape(B, N, L * RW).contiguous()
        ref = beam_gather_rows_plain(x, src)
        check(torch.equal(beam_gather_rows(x, src), ref),
              f"beam_gather_rows {tag}")
        rec = dict(ms=cuda_ms(lambda: beam_gather_rows(x, src), 20),
                   plain_ms=cuda_ms(
                       lambda: beam_gather_rows_plain(x, src), 5),
                   library_ms=cuda_ms(lambda: x[bidx, src.long()], 5),
                   max_abs_err=0.0)
        row = L * RW * x.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(
            uniq * row + B * N * row + nbytes(src))
        results.append(("beam_gather_rows", tag, rec))
    del cache


def print_checks(recs):
    for name, tg, r in recs:
        print("kernel_check", json.dumps({"kernel": name, "case": tg, **r}))


def reorder_body_case(results, tag, cache, kvg, src, t, fused, timed):
    """One K1 body (K1', K1'') at [B, N, L, Mc, RW] against its plain
    version, bit-equal; ``timed``: its times and bound too (reading each
    source slab and kvg row the search needs once, writing every slab)."""
    import torch
    from ripor_tpu_torch.ops import reorder_cache_all, reorder_cache_all_plain
    from ripor_tpu_torch.ops.megarow import reorder_body
    name = reorder_body(kvg.dtype != cache.dtype, fused)
    dst = torch.empty_like(cache)

    def run(fn, out):
        return fn(kvg, cache, out, src, t, H, fused_kvg=fused)
    out = run(reorder_cache_all, dst)
    ref = run(reorder_cache_all_plain, torch.empty_like(cache))
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"{name} {tag}")
    del ref
    rec = dict(max_abs_err=0.0, library_ms=None, t=t)
    if timed:
        uniq = unique_sources(src)
        slab = L * cache.shape[3] * cache.shape[4] * cache.element_size()
        krow = kvg.shape[2] * kvg.element_size()
        rec.update(ms=cuda_ms(lambda: run(reorder_cache_all, dst), 5),
                   plain_ms=cuda_ms(lambda: run(reorder_cache_all_plain,
                                                dst), 3))
        rec["bound_ms"], rec["bound_by"] = bound(
            uniq * slab + B * N * slab + (uniq if fused else B * N) * krow
            + nbytes(src))
    results.append((name, tag, rec))


def dataflow_checks(results, g):
    """Phase 2, the megarow dataflows' bodies at the main path's shapes,
    against their plain versions: K1' (exact bf16 rows quantized on
    insert into int8 and int4 caches) at Mc 8 and 32, at t = 0 and a
    middle t; K1'' (kvg read through src) on int4 rows with QFUSE's int8
    rows, exact rows quantized into int4 and int8 caches, and exact bf16
    rows into a bf16 cache, at Mc = 32; all bit-equal. K2' (mxu_math) on
    int8 and int4 rows at every segment size, at the staged kernels' bar
    (2e-2), its QFUSE rows bit-equal; and with f32 q at Mc = 32, where the
    bf16 output no longer hides its exact p*v products (mxu_exact_case)."""
    import torch
    n_before = len(results)
    for quant in ("int4", "int8"):
        for Mc in (SEGMENTS[0], SEGMENTS[-1]):
            cache = random_rows(quant, (B, N, L, Mc), g)
            for t in (0, Mc // 2):
                src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                                    dtype=torch.int32)
                kvg = random_rows(None, (B, N, L), g).reshape(B, N, -1)
                reorder_body_case(results, f"{quant} Mc={Mc} t={t}", cache,
                                  kvg, src, t, False, t > 0)
            del cache
            torch.cuda.empty_cache()
    Mc, t = SEGMENTS[-1], SEGMENTS[-1] // 2
    for form, quant in (("int4 rows", "int4"), ("int4 quantized", "int4"),
                        ("int8 quantized", "int8"), ("bf16 exact", None)):
        cache = random_rows(quant, (B, N, L, Mc), g)
        src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                            dtype=torch.int32)
        kvg = random_rows(quant if form.endswith("rows") else None,
                          (B, N, L), g).reshape(B, N, -1)
        reorder_body_case(results, f"{form} Mc={Mc}", cache, kvg, src, t,
                          True, True)
        del cache, kvg
        torch.cuda.empty_cache()
    for Mc in SEGMENTS:
        for quant in ("int4", "int8"):
            cache = random_rows(quant, (B, N, L, Mc), g)
            step_attention_seq_case(results, f"{quant} Mc={Mc}", quant,
                                    cache, Mc, Mc - 1, g, mxu=True)
            del cache
            torch.cuda.empty_cache()
    for quant in ("int4", "int8"):
        mxu_exact_case(results, quant, SEGMENTS[-1], g)
    print_checks(results[n_before:])


def mxu_exact_case(results, quant, Mc, g, layer=5):
    """K2' with f32 q, kv_new and output on an int8/int4 [B, N, L, Mc, RW]
    cache at t = Mc - 1, against the exact-product plain version (plain
    K2', and plain K2, whose p*v products are rounded to bf16).

    Gates: K2''s mean abs error is under a tenth of the rounded plain
    version's mean gap to the exact one, and the same gate refuses the
    K2 kernel launched on these inputs, so a K2' that rounds its products
    as K2 does fails here. Both versions round each probability (times
    its V scale) to bf16, so a last-bit difference in a score flips that
    rounding where it lies on a midpoint: a head-row whose error exceeds a
    tenth of the rounded gap's max must be one bf16 step of one
    probability times that slot's V row, up to a tenth of that max
    (``pv_flips``)."""
    import torch
    from ripor_tpu_torch.ops import step_attention_seq, step_attention_seq_plain
    cache = random_rows(quant, (B, N, L, Mc), g)
    q, kv_new, bias_hist, bias_new = attention_inputs(Mc, Mc - 1, g,
                                                      dtype=torch.float32)
    args = (q, kv_new, cache, layer, bias_hist, bias_new, H)
    got = step_attention_seq(*args, mxu_math=True)
    k2 = step_attention_seq(*args)
    exact = step_attention_seq_plain(*args, mxu_math=True)
    rounded = step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    err, gap = (got - exact).abs(), (rounded - exact).abs()
    k2_err = (k2 - exact).abs().mean().item()
    rec = dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
               rounded_gap_max=gap.max().item(),
               rounded_gap_mean=gap.mean().item(), k2_mean_abs_err=k2_err,
               library_ms=None)
    tag = f"{quant} f32 q Mc={Mc}"
    check(rec["mean_abs_err"] * 10 < rec["rounded_gap_mean"],
          f"step_attention_seq_mxu {tag}: mean abs err "
          f"{rec['mean_abs_err']} not under a tenth of the rounded "
          f"products' mean gap {rec['rounded_gap_mean']}")
    check(not k2_err * 10 < rec["rounded_gap_mean"],
          f"step_attention_seq_mxu {tag}: the gate does not refuse K2's "
          f"rounded products (mean abs err {k2_err})")
    rec["flips"], rec["unexplained"] = pv_flips(
        got - exact, args, rec["rounded_gap_max"] / 10)
    check(rec["unexplained"] == 0,
          f"step_attention_seq_mxu {tag}: {rec['unexplained']} head-rows "
          f"off by more than one probability's bf16 step")
    results.append(("step_attention_seq_mxu", tag, rec))
    del cache, got, k2, exact, rounded, err, gap
    torch.cuda.empty_cache()


def pv_flips(diff, args, tol):
    """Head-rows of an attention output difference ``diff`` [B, N, F]
    whose max exceeds ``tol``, and how many of them are not one bf16 step
    of one probability p_j (times its V scale, as attend_plain rounds it)
    times slot j's V row, up to ``tol``."""
    import torch
    from ripor_tpu_torch.ops.attend_reorder import cache_quant, decode_rows
    q, kv_new, cache, layer, bias_hist, bias_new, Hh = args
    Bq, Nq, Fq = q.shape
    D, Mc = Fq // Hh, cache.shape[3]
    k, v, ek, ev = decode_rows(cache[:, :, layer], Fq, Hh,
                               cache_quant(cache, Fq))
    qb = q.to(torch.bfloat16)
    s = (k * qb[:, :, None]).float().reshape(Bq, Nq, Mc, Hh, D).sum(-1)
    s_new = (kv_new[..., :Fq].to(torch.bfloat16) * qb).float().reshape(
        Bq, Nq, Hh, D).sum(-1) + bias_new
    probs = torch.softmax(torch.cat([s * ek + bias_hist, s_new[:, :, None]],
                                    2), 2)
    ps = torch.cat([probs[:, :, :Mc] * ev, probs[:, :, Mc:]], 2).double()
    diff = diff.reshape(Bq, Nq, Hh, D).double()
    rows = (diff.abs().amax(-1) > tol).nonzero().tolist()
    unexplained = 0
    for b, n, h in rows:
        V = torch.cat([v[b, n, :, h * D:(h + 1) * D].double(),
                       kv_new[b, n, None, Fq + h * D:Fq + (h + 1) * D]
                       .double()])                    # [Mc + 1, D]
        e = diff[b, n, h]
        c = (V @ e) / (V * V).sum(1).clamp_min(1e-30)
        j = int((e - c[:, None] * V).abs().amax(1).argmin())
        ulp = 2.0 ** (torch.floor(torch.log2(ps[b, n, j, h].abs())) - 7)
        if not (abs(c[j]) <= 1.001 * ulp
                and (e - c[j] * V[j]).abs().max() <= tol):
            unexplained += 1
    return len(rows), unexplained


def step_attention_seq_case(results, tag, quant, cache, Mc, t, g, layer=5,
                            width=(F, H), tol=2e-2, mxu=False):
    """K2 (with ``mxu``, K2') at ``layer`` of a [B, N, L, Mc, RW] cache
    against its plain version, with the QFUSE rows for quantized caches
    (bit-equal)."""
    import torch
    from ripor_tpu_torch.ops import (step_attention_seq,
                                     step_attention_seq_plain)
    from ripor_tpu_torch.ops.staging import stage_plan
    F, H = width
    RW = cache.shape[-1]
    q, kv_new, bias_hist, bias_new = attention_inputs(
        Mc, t, g, width, torch.float32 if cache.dtype == torch.float32
        else None)
    args = (q, kv_new, cache, layer, bias_hist, bias_new, H, quant, mxu)
    name = "step_attention_seq_mxu" if mxu else "step_attention_seq"
    got = step_attention_seq(*args)
    want = step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    if quant:
        (got, got_q), (want, want_q) = got, want
        check(torch.equal(got_q, want_q), f"{name} emit_quant rows {tag}")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"{name} {tag}: max abs err {err}")
    plan = stage_plan(quant, cache.element_size(), q.element_size(), Mc, F, H)
    rec = dict(ms=cuda_ms(lambda: step_attention_seq(*args), 20),
               plain_ms=cuda_ms(lambda: step_attention_seq_plain(*args), 3),
               library_ms=None, max_abs_err=err, stages=plan.stages,
               chunk_slots=plan.chunk_slots, smem_bytes=plan.smem_bytes)
    outs = nbytes(got) + (B * N * RW if quant else 0)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(q, kv_new, bias_hist, bias_new) + outs
        + B * N * Mc * RW * cache.element_size(), 4.0 * B * N * (Mc + 1) * F)
    results.append((name, tag, rec))


def step_attend_reorder_case(results, tag, quant, kvg_q8, Mc, g, layer=5,
                             width=(F, H), Lw=L, dtype=None, tol=2e-2):
    """K4 at ``layer`` of a [Lw, B, N, Mc, RW] cache at t = Mc - 1 with
    write_back on against its plain version: the written layer bit-equal,
    the attention within ``tol``."""
    import torch
    from ripor_tpu_torch.ops import (step_attend_reorder,
                                     step_attend_reorder_plain)
    from ripor_tpu_torch.ops.staging import stage_plan
    F, H = width
    cache = random_rows(quant, (Lw, B, N, Mc), g, width, dtype)
    RW, esz = cache.shape[-1], cache.element_size()
    t = Mc - 1
    src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                        dtype=torch.int32)
    kvg = (random_rows("int8", (B, N, Lw), g, width) if kvg_q8 else
           random_rows(None, (B, N, Lw), g, width, dtype)).reshape(B, N, -1)
    q, kv_new, bias_hist, bias_new = attention_inputs(Mc, t, g, width, dtype)
    dst, dst_plain = torch.empty_like(cache), torch.empty_like(cache)

    def run(fn, out):
        return fn(q, kv_new, kvg, cache, out, src, layer, t, bias_hist,
                  bias_new, H)[0]

    got = run(step_attend_reorder, dst)
    want = run(step_attend_reorder_plain, dst_plain)
    torch.cuda.synchronize()
    check(torch.equal(dst[layer], dst_plain[layer]),
          f"step_attend_reorder cache_dst {tag}")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"step_attend_reorder {tag}: max abs err {err}")
    plan = stage_plan(quant, esz, q.element_size(), Mc, F, H,
                      exact_kvg=quant is not None and not kvg_q8)
    rec = dict(ms=cuda_ms(lambda: run(step_attend_reorder, dst), 20),
               plain_ms=cuda_ms(lambda: run(
                   step_attend_reorder_plain, dst_plain), 3),
               library_ms=None, max_abs_err=err, stages=plan.stages,
               chunk_slots=plan.chunk_slots, smem_bytes=plan.smem_bytes)
    slab = Mc * RW * esz
    rec["bound_ms"], rec["bound_by"] = bound(
        unique_sources(src) * slab + B * N * slab
        + nbytes(q, kv_new, src, bias_hist, bias_new, got)
        + nbytes(kvg) // Lw, 4.0 * B * N * (Mc + 1) * F)
    results.append(("step_attend_reorder", tag, rec))
    print("kernel_check", json.dumps({
        "kernel": "step_attend_reorder", "case": tag, **rec}))


def deferred_checks(results, g):
    """Phase 2, K4 against its plain version: layer 5 of a [L, B, N, Mc,
    RW] cache at t = Mc - 1 with write_back on, for int4, int8 (exact and
    pre-quantized kvg rows) and bf16 caches. The written layer is
    bit-equal, the attention within 2e-2."""
    import torch
    for Mc in SEGMENTS:
        for quant, kvg_q8 in (("int4", False), ("int8", False),
                              ("int8", True), (None, False)):
            tag = f"{quant or 'bf16'}{' kvg int8' if kvg_q8 else ''} Mc={Mc}"
            step_attend_reorder_case(results, tag, quant, kvg_q8, Mc, g)
            torch.cuda.empty_cache()


# slabs larger than one stage (slot chunks): (kernel, rows, width) at
# Mc = 32 on a lead of one layer, B = 8, N = 1000
T5_3B, T5_LARGE = (4096, 32), (1024, 16)
OVERSIZED = (("K2", "bf16", T5_3B), ("K2", "int8", T5_3B),
             ("K2", "f32", T5_LARGE), ("K4", "bf16", T5_3B),
             ("K4", "int8", T5_3B), ("K4", "f32", T5_LARGE),
             ("K5", "f32", T5_LARGE), ("K5", "bf16", T5_3B),
             ("K8", "f32", T5_LARGE), ("K8", "bf16", T5_3B))


def oversized_checks(results, g):
    """Phase 2, the staged kernels on slabs no stage can hold, against
    their plain versions (f32 within 1e-4, else 2e-2): K2 and K4 at t5-3b
    widths in bf16 and int8 rows (K4's int8 case in its quantize mode) and
    at t5-large in f32; K5 and K8 at t5-large in f32 and at t5-3b in bf16;
    each with its plan (slots a stage holds)."""
    import torch
    Mc = 32
    for kernel, rows, width in OVERSIZED:
        Fw, Hw = width
        name = "t5-3b" if width == T5_3B else "t5-large"
        tag = f"{rows} Mc={Mc} {name} (F={Fw}, H={Hw}), L=1"
        dtype = torch.float32 if rows == "f32" else torch.bfloat16
        tol = 1e-4 if rows == "f32" else 2e-2
        quant = rows if rows == "int8" else None
        if kernel == "K2":
            cache = random_rows(quant, (B, N, 1, Mc), g, width, dtype)
            step_attention_seq_case(results, tag, quant, cache, Mc, Mc - 1,
                                    g, 0, width, tol)
            print("kernel_check", json.dumps({
                "kernel": "step_attention_seq", "case": tag,
                **results[-1][2]}))
            del cache
        elif kernel == "K4":
            step_attend_reorder_case(results, tag, quant, False, Mc, g, 0,
                                     width, 1, dtype, tol)
        else:
            kv = torch.randn(1, 2, B, N, Mc, Fw, generator=g, device="cuda",
                             dtype=dtype)
            q, kv_new, bias_hist, bias_new = attention_inputs(
                Mc, Mc - 1, g, width, dtype)
            if kernel == "K5":
                step_attention_fused_case(
                    results, tag, kv, q, kv_new[..., :Fw].contiguous(),
                    kv_new[..., Fw:].contiguous(), bias_hist, bias_new, Hw,
                    tol, 0, yardstick=False)
            else:
                bias_hist[Mc - 1:] = torch.randn(1, Hw, generator=g,
                                                 device="cuda")
                step_attention_case(results, tag, q, kv[0, 0], kv[0, 1],
                                    bias_hist, Hw, tol, yardstick=False)
            del kv, q, kv_new
        check(results[-1][2]["chunk_slots"] < Mc,
              f"{kernel} {tag}: the plan does not chunk")
        torch.cuda.empty_cache()


def sdpa_yardstick(q, keys, values, mask, H):
    """One scaled_dot_product_attention call on [B*N, H, 1|P, D] views of
    q [B, N, F] and keys, values [B, N, P, F], with the additive mask [H,
    P] and no scaling (T5): a yardstick the port never calls. Returns the
    call and its output as [B, N, F]."""
    import torch.nn.functional as tf
    Bq, Nq, P, Fq = keys.shape
    D = Fq // H
    qh = q.view(Bq * Nq, 1, H, D).transpose(1, 2)
    kh = keys.view(Bq * Nq, P, H, D).transpose(1, 2)
    vh = values.view(Bq * Nq, P, H, D).transpose(1, 2)
    m = mask.to(q.dtype).reshape(1, H, 1, P)

    def sdpa():
        return tf.scaled_dot_product_attention(qh, kh, vh, attn_mask=m,
                                               scale=1.0)
    return sdpa, sdpa().transpose(1, 2).reshape(Bq, Nq, Fq)


def step_attention_fused_case(results, tag, cache, q, k_new, v_new,
                              bias_hist, bias_new, Hh, tol, layer,
                              yardstick=True):
    """K5 at ``layer`` of a [L, 2, B, N, Mc, F] cache against its plain
    version, with its plan, bound and (at the paths' shapes) the SDPA
    yardstick over the Mc + 1 positions (keys and values concatenated
    outside the timed call)."""
    import torch
    from ripor_tpu_torch.ops import (step_attention_fused,
                                     step_attention_fused_plain)
    from ripor_tpu_torch.ops.staging import stage_plan
    Bq, Nq, Fq = q.shape
    Mc = cache.shape[4]
    args = (q, k_new, v_new, cache, layer, bias_hist, bias_new, Hh)
    got = step_attention_fused(*args)
    want = step_attention_fused_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"step_attention_fused {tag}: max abs err {err}")
    esz = cache.element_size()
    plan = stage_plan(None, esz, esz, Mc, Fq, Hh, planes=True)
    rec = dict(ms=cuda_ms(lambda: step_attention_fused(*args), 10),
               plain_ms=cuda_ms(lambda: step_attention_fused_plain(*args), 2),
               library_ms=None, max_abs_err=err, stages=plan.stages,
               chunk_slots=plan.chunk_slots, smem_bytes=plan.smem_bytes)
    if yardstick:
        keys = torch.cat([cache[layer, 0], k_new[:, :, None]], dim=2)
        vals = torch.cat([cache[layer, 1], v_new[:, :, None]], dim=2)
        sdpa, lib = sdpa_yardstick(q, keys, vals,
                                   torch.cat([bias_hist, bias_new]).T, Hh)
        rec.update(library_ms=cuda_ms(sdpa, 10),
                   library="scaled_dot_product_attention",
                   library_max_abs_err=(
                       lib.float() - want.float()).abs().max().item())
        del keys, vals, lib
    rec["bound_ms"], rec["bound_by"] = bound(
        2 * Bq * Nq * Mc * Fq * esz
        + nbytes(q, k_new, v_new, bias_hist, bias_new, got),
        4.0 * Bq * Nq * (Mc + 1) * Fq)
    results.append(("step_attention_fused", tag, rec))
    print("kernel_check", json.dumps({"kernel": "step_attention_fused",
                                      "case": tag, **rec}))


def non_deferred_checks(results, g):
    """Phase 2, K5 (layer 5; bf16 at every segment size within 2e-2, f32
    at Mc=32 within 1e-4) and K6 (the non-deferred reorder over the L*2*B
    planes with src tiled, bit-equal; Mc in {8, 32}) against their plain
    versions on a [L, 2, B, N, Mc, F] cache."""
    import torch
    for Mc, dtype in ([(m, torch.bfloat16) for m in SEGMENTS]
                      + [(32, torch.float32)]):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        tag = f"{name} Mc={Mc}"
        t = Mc - 1
        cache = torch.randn(L, 2, B, N, Mc, F, generator=g, device="cuda",
                            dtype=dtype)
        q, kv_new, bias_hist, bias_new = attention_inputs(Mc, t, g)
        q = q.to(dtype)
        k_new = kv_new[..., :F].to(dtype).contiguous()
        v_new = kv_new[..., F:].to(dtype).contiguous()
        step_attention_fused_case(results, tag, cache, q, k_new, v_new,
                                  bias_hist, bias_new, H,
                                  2e-2 if name == "bf16" else 1e-4, 5)
        if name != "bf16" or Mc not in (SEGMENTS[0], SEGMENTS[-1]):
            del cache
            torch.cuda.empty_cache()
            continue

        gather_update_case(results, tag, cache, t, g)
        del cache
        torch.cuda.empty_cache()


def gather_update_case(results, tag, cache, t, g):
    """K6, the non-deferred reorder over the L*2*B planes of a [L, 2, B,
    N, Mc, Fw] cache with src tiled and slot t inserted, against its plain
    version (bit-equal)."""
    import torch
    from ripor_tpu_torch.ops import (beam_gather_update,
                                     beam_gather_update_plain)
    Lw, _, Bq, Nq, Mc, Fw = cache.shape
    G = Lw * 2 * Bq
    flat = cache.view(G, Nq, Mc, Fw)
    src = torch.randint(0, Nq, (Bq, Nq), generator=g, device="cuda",
                        dtype=torch.int32)
    src_rep = src.repeat(Lw * 2, 1)
    kvg = torch.randn(G, Nq, Fw, generator=g, device="cuda",
                      dtype=cache.dtype)
    out, out_plain = torch.empty_like(flat), torch.empty_like(flat)
    beam_gather_update(flat, kvg, src_rep, t, out)
    beam_gather_update_plain(flat, kvg, src_rep, t, out_plain)
    torch.cuda.synchronize()
    check(torch.equal(out, out_plain), f"beam_gather_update {tag}")
    del out_plain
    gidx = torch.arange(G, device="cuda")[:, None]
    lsrc = src_rep.long()
    rec = dict(ms=cuda_ms(lambda: beam_gather_update(
                   flat, kvg, src_rep, t, out), 10),
               plain_ms=cuda_ms(lambda: beam_gather_update_plain(
                   flat, kvg, src_rep, t, out), 2),
               library_ms=cuda_ms(lambda: flat[gidx, lsrc], 2),
               max_abs_err=0.0)
    slab = Mc * Fw * flat.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(
        Lw * 2 * unique_sources(src) * slab + G * Nq * slab
        + nbytes(kvg, src_rep))
    results.append(("beam_gather_update", tag, rec))
    print("kernel_check", json.dumps({"kernel": "beam_gather_update",
                                      "case": tag, **rec}))


def step_attention_case(results, tag, q, ck, cv, bias, Hh, tol,
                        yardstick=True):
    """K8 over K and V planes [B, N, Mc, F] against its plain version,
    with its plan, bound and (at the paths' shapes) the SDPA yardstick."""
    import torch
    from ripor_tpu_torch.ops import step_attention, step_attention_plain
    from ripor_tpu_torch.ops.staging import stage_plan
    Bq, Nq, Mc, Fq = ck.shape
    args = (q, ck, cv, bias, Hh)
    got = step_attention(*args)
    want = step_attention_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"step_attention {tag}: max abs err {err}")
    esz = ck.element_size()
    plan = stage_plan(None, esz, esz, Mc, Fq, Hh, planes=True, new=False)
    rec = dict(ms=cuda_ms(lambda: step_attention(*args), 10),
               plain_ms=cuda_ms(lambda: step_attention_plain(*args), 2),
               library_ms=None, max_abs_err=err, stages=plan.stages,
               chunk_slots=plan.chunk_slots, smem_bytes=plan.smem_bytes)
    if yardstick:
        sdpa, lib = sdpa_yardstick(q, ck, cv, bias.T, Hh)
        rec.update(library_ms=cuda_ms(sdpa, 10),
                   library="scaled_dot_product_attention",
                   library_max_abs_err=(
                       lib.float() - want.float()).abs().max().item())
        del lib
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(q, ck, cv, bias, got), 4.0 * Bq * Nq * Mc * Fq)
    results.append(("step_attention", tag, rec))
    print("kernel_check", json.dumps({"kernel": "step_attention",
                                      "case": tag, **rec}))


def write_attend_checks(results, g):
    """Phase 2, the write-then-attend kernels against their plain
    versions: K8 over one layer's K and V planes [B, N, Mc, F] (bf16
    within 2e-2, f32 within 1e-4) at every segment size, at t = Mc - 1 and
    a t in the middle (slots above t masked), and K7 over the [L*2*B, N,
    Mc, F] view of the stacked cache (bf16, int8 and a narrow int8 block:
    bit-equal)."""
    import torch
    for Mc in SEGMENTS:
        for dtype, name, tol in ((torch.bfloat16, "bf16", 2e-2),
                                 (torch.float32, "f32", 1e-4)):
            kv = torch.randn(2, B, N, Mc, F, generator=g, device="cuda",
                             dtype=dtype)
            q = torch.randn(B, N, F, generator=g, device="cuda", dtype=dtype)
            for t in (Mc - 1, Mc // 2):
                bias = torch.randn(Mc, H, generator=g, device="cuda")
                bias[t + 1:] = -1e30
                step_attention_case(results, f"{name} Mc={Mc} t={t}", q,
                                    kv[0], kv[1], bias, H, tol)
            del kv, q
            torch.cuda.empty_cache()

    for dtype, Mc, C in ((torch.bfloat16, 8, F), (torch.bfloat16, 32, F),
                         (torch.int8, 32, F), (torch.int8, 3, 13)):
        tag = (f"{'bf16' if dtype == torch.bfloat16 else 'int8'} Mc={Mc}"
               + ("" if C == F else f" C={C}"))
        gather_blocks_case(results, tag, dtype, Mc, C, g)
        torch.cuda.empty_cache()


def gather_blocks_case(results, tag, dtype, Mc, C, g):
    """K7 over the [L*2*B, N, Mc, C] view of a stacked cache, against its
    plain version (bit-equal)."""
    import torch
    from ripor_tpu_torch.ops import (beam_gather_blocks,
                                     beam_gather_blocks_plain)
    G = L * 2 * B
    cache = (torch.randn(G, N, Mc, C, generator=g, device="cuda",
                         dtype=dtype) if dtype.is_floating_point else
             torch.randint(-128, 128, (G, N, Mc, C), generator=g,
                           device="cuda", dtype=dtype))
    src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                        dtype=torch.int32)
    src_rep = src.repeat(L * 2, 1)
    out = torch.empty_like(cache)
    beam_gather_blocks(cache, src_rep, out)
    ref = beam_gather_blocks_plain(cache, src_rep)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), f"beam_gather_blocks {tag}")
    del ref
    gidx = torch.arange(G, device="cuda")[:, None]
    lsrc = src_rep.long()
    rec = dict(ms=cuda_ms(lambda: beam_gather_blocks(cache, src_rep,
                                                     out), 10),
               plain_ms=cuda_ms(lambda: beam_gather_blocks_plain(
                   cache, src_rep, out), 2),
               library_ms=cuda_ms(lambda: cache[gidx, lsrc], 2),
               max_abs_err=0.0)
    slab = Mc * C * cache.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(
        L * 2 * unique_sources(src) * slab + G * N * slab
        + nbytes(src_rep))
    results.append(("beam_gather_blocks", tag, rec))
    print("kernel_check", json.dumps({
        "kernel": "beam_gather_blocks", "case": tag, **rec}))


# the per-rank width of t5-base under 2-way tensor parallelism (phase 12)
TP_WIDTH = (F // 2, H // 2)


def tp_width_checks(results, g):
    """Phase 2, each of K1-K8 at TP_WIDTH (F=384, H=6: the heads of one of
    two model ranks at t5-base), B=8, N=1000, L=12, against its plain
    version at phase 2's bars: K1-K3 on int4 rows (phase 12's cache) at
    every segment's Mc (t = Mc - 1), and at Mc=32, t=31 K4 on int4 rows,
    K5, K6 on the bf16 stacked cache, K7 and K8 on bf16 planes."""
    import torch
    Fw, Hw = TP_WIDTH
    for Mc in SEGMENTS:
        n_before = len(results)
        megarow_case(results, f"int4 Mc={Mc} H={Hw} F={Fw}", "int4", Mc, g,
                     width=TP_WIDTH)
        print_checks(results[n_before:])
    Mc, t = 32, 31
    tag = f"int4 Mc={Mc} H={Hw} F={Fw}"
    step_attend_reorder_case(results, tag, "int4", False, Mc, g,
                             width=TP_WIDTH)
    tag = f"bf16 Mc={Mc} H={Hw} F={Fw}"
    cache = torch.randn(L, 2, B, N, Mc, Fw, generator=g, device="cuda",
                        dtype=torch.bfloat16)
    q, kv_new, bias_hist, bias_new = attention_inputs(Mc, t, g, TP_WIDTH)
    step_attention_fused_case(results, tag, cache, q,
                              kv_new[..., :Fw].contiguous(),
                              kv_new[..., Fw:].contiguous(), bias_hist,
                              bias_new, Hw, 2e-2, 5)
    gather_update_case(results, tag, cache, t, g)
    bias_hist[t:] = torch.randn(Mc - t, Hw, generator=g, device="cuda")
    step_attention_case(results, f"{tag} t={t}", q, cache[5, 0],
                        cache[5, 1], bias_hist, Hw, 2e-2)
    del cache, q, kv_new
    gather_blocks_case(results, tag, torch.bfloat16, Mc, Fw, g)
    torch.cuda.empty_cache()


def decode_plan(P, cache_segments=4):
    """The steps of a default-path search of P steps with exact rows, as
    make_beam_search_fn takes them: (megarow, [(t, Mc), ...]), Mc the
    slots of step t's cache. Megarow when every segment span is even,
    else the non-deferred path."""
    from ripor_tpu_torch.decode.beam import _segment_bounds
    bounds = _segment_bounds(P, cache_segments)
    spans = list(zip([0] + bounds[:-1], bounds))
    return (all((hi - lo) % 2 == 0 for lo, hi in spans),
            [(t, hi) for lo, hi in spans for t in range(lo, hi)])


def decode_launches(Lw, P, searches, cache_segments=4):
    """Launches of ``searches`` such searches over an Lw-layer decoder.
    Megarow: K1 once a step, K2 once a layer a step, K3 once a step but
    the last. Non-deferred: K5 once a layer a step, K3 and K6 once a step
    but the last."""
    megarow, steps = decode_plan(P, cache_segments)
    n = len(steps)
    per = ({"reorder_cache_all": n, "step_attention_seq": n * Lw,
            "beam_gather_rows": n - 1} if megarow else
           {"step_attention_fused": n * Lw, "beam_gather_rows": n - 1,
            "beam_gather_update": n - 1})
    return {k: v * searches for k, v in per.items()}


def sum_counts(parts):
    out = {}
    for part in parts:
        for k, n in part.items():
            out[k] = out.get(k, 0) + n
    return out


def pipeline_searches(sz):
    """The bf16 exact-row searches of phase 11 (cache_segments=4) as
    path_shape_checks takes them, ((F, H, L), B, N, P, 4, None, "bf16"):
    (a) and (d) datagen_round at batch 4 and beam sz["beam"]; (b)
    datagen_round at batch 4 and beam min(num_beams, 10) over the
    curriculum, and stage_retrieve at batch 8 and beam num_beams over the
    full trie and each prefix_eval length; (c) the same two at RECIPE_KW's
    model (the recipe's small config)."""
    from ripor_tpu_torch.models import ripor_base
    from ripor_tpu_torch.pipeline.full_recipe import _small_cfg

    def width(c):
        return (c.t5.inner_dim, c.t5.num_heads, c.t5.num_decoder_layers)
    kw, fk = sz["recipe_kw"], sz["floors_kw"]
    big = width(sz["recipe_cfg"] or ripor_base(M=M, K=K))
    small_cfg = _small_cfg(fk["M"], fk["K"], fk["vocab_size"])
    small = width(small_cfg)
    small_plens = sorted({p for p in (4, 8, 16, 32) if p < fk["M"]}
                         | {fk["M"]})
    out = [(big, 4, sz["beam"], p) for p in sz["prefix_lengths"]]
    out += [(big, 4, min(kw["num_beams"], 10), p) for p in kw["curriculum"]]
    out += [(big, 8, kw["num_beams"], p) for p in (M, *kw["prefix_eval"])]
    out += [(small, 4, min(fk["num_beams"], 10), p) for p in small_plens]
    out += [(small, 8, fk["num_beams"], fk["M"])]
    return [(*search, 4, None, "bf16") for search in dict.fromkeys(out)]


def mesh_searches(sz):
    """The searches of phase 12's ranks, each rank's share, as
    path_shape_checks takes them: DP and the engine (data=2: B/2 queries
    at t5-base width) and TP (model=2: H/2 heads, F/2) in bf16 on sz's
    cache, TP in f32 on an exact cache, and the TOY_TP searches (model=2
    over ripor_small(M=4, K=8), f32, 5 beams, 8 queries)."""
    from ripor_tpu_torch.models import ripor_base, ripor_small

    def width(c, mp):
        return (c.t5.inner_dim // mp, c.t5.num_heads // mp,
                c.t5.num_decoder_layers)
    big, toy = ripor_base(M=M, K=K), ripor_small(M=4, K=8)
    q, Bq, Nq = sz["quant"], sz["batch"], sz["beam"]
    out = [(width(big, 1), Bq // 2, Nq, big.M, 4, q, "bf16"),
           (width(big, 2), Bq, Nq, big.M, 4, q, "bf16"),
           (width(big, 2), Bq, Nq, big.M, 4, None, "f32")]
    out += [(width(toy, 2), 8, 5, toy.M, kw["cache_segments"],
             kw.get("kv_cache_quant"), "f32") for kw, *_ in TOY_TP.values()]
    return out


def path_shape_checks(results, g, phase, searches):
    """Phase 2, the kernels of a later phase's searches at their shapes:
    searches ((F, H, L), B, N, P, cache_segments, quant, dtype); at every
    step t of each, on its cache of Mc slots with step t's biases
    (history slots >= t masked) and one layer a step in turn, each kernel
    the step launches against its plain version on random rows. Megarow:
    K1 and K3 bit-equal, K2 within 1e-4 on exact f32 rows and 2e-2
    otherwise (quantized rows take bf16 dots whatever q's dtype), its
    quantized rows bit-equal; non-deferred (exact rows only): K5 within
    the same, K3 and K6 bit-equal (phase 2's bars). One record per search
    and kernel: its worst error and steps."""
    import torch
    from ripor_tpu_torch.models.t5 import Decoder
    from ripor_tpu_torch.ops import (beam_gather_rows, beam_gather_rows_plain,
                                     beam_gather_update,
                                     beam_gather_update_plain,
                                     reorder_cache_all,
                                     reorder_cache_all_plain,
                                     step_attention_fused,
                                     step_attention_fused_plain,
                                     step_attention_seq,
                                     step_attention_seq_plain)

    def close(name, got, want, tg, tol):
        err = (got.float() - want.float()).abs().max().item()
        check(torch.allclose(got.float(), want.float(), rtol=tol,
                             atol=tol), f"{name} {tg}: max abs err {err}")
        return err

    for (Fw, Hw, Lw), Bq, Nq, P, segs, quant, dname in searches:
        megarow, steps = decode_plan(P, segs)
        check(megarow or quant is None,
              f"{phase}: a quantized search off the megarow path")
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
        # quantized rows take their dots in bf16 (the plain version's
        # math), so only exact f32 rows hold f32's bar
        tol = 1e-4 if dt == torch.float32 and quant is None else 2e-2

        def randn(*shape):
            return torch.randn(*shape, generator=g, device="cuda", dtype=dt)

        def step_rows():        # a step's rows of every layer, valid
            return random_rows(quant, (Bq, Nq, Lw), g, (Fw, Hw),
                               dt).reshape(Bq, Nq, -1)

        tag = (f"{phase} F={Fw} H={Hw} L={Lw} B={Bq} N={Nq} P={P} "
               f"{quant or 'exact'} {dname}")
        errs = {}
        full_bias = torch.randn(Hw, P, P, generator=g, device="cuda")
        for t, Mc in steps:
            tg = f"{tag} t={t} Mc={Mc}"
            layer, last = t % Lw, t == P - 1
            bias_hist, bias_new = Decoder._step_biases(full_bias, t, Mc)
            src = torch.randint(0, Nq, (Bq, Nq), generator=g, device="cuda",
                                dtype=torch.int32)
            q = randn(Bq, Nq, Fw)
            if megarow:
                cache = random_rows(quant, (Bq, Nq, Lw, Mc), g, (Fw, Hw), dt)
                kvg = step_rows()
                out = reorder_cache_all(kvg, cache, torch.empty_like(cache),
                                        src, t)
                ref = reorder_cache_all_plain(kvg, cache,
                                              torch.empty_like(cache), src, t)
                check(torch.equal(out, ref), f"reorder_cache_all {tg}")
                del cache, ref
                errs.setdefault("reorder_cache_all", []).append(0.0)
                args = (q, randn(Bq, Nq, 2 * Fw), out, layer, bias_hist,
                        bias_new, Hw, quant)
                got, want = (step_attention_seq(*args),
                             step_attention_seq_plain(*args))
                if quant:
                    (got, got_q), (want, want_q) = got, want
                    check(torch.equal(got_q, want_q),
                          f"step_attention_seq emit_quant rows {tg}")
                errs.setdefault("step_attention_seq", []).append(close(
                    "step_attention_seq", got, want, tg, tol))
                del out
                if not last:
                    rows = step_rows()
                    check(torch.equal(beam_gather_rows(rows, src),
                                      beam_gather_rows_plain(rows, src)),
                          f"beam_gather_rows {tg}")
                    errs.setdefault("beam_gather_rows", []).append(0.0)
                continue
            cache = randn(Lw, 2, Bq, Nq, Mc, Fw)
            args = (q, randn(Bq, Nq, Fw), randn(Bq, Nq, Fw), cache, layer,
                    bias_hist, bias_new, Hw)
            errs.setdefault("step_attention_fused", []).append(close(
                "step_attention_fused", step_attention_fused(*args),
                step_attention_fused_plain(*args), tg, tol))
            if last:
                continue
            G = Lw * 2 * Bq
            src_rep = src.repeat(Lw * 2, 1)
            rows = randn(G, Nq, Fw)
            kvg = beam_gather_rows(rows, src_rep)
            check(torch.equal(kvg, beam_gather_rows_plain(rows, src_rep)),
                  f"beam_gather_rows {tg}")
            planes = cache.view(G, Nq, Mc, Fw)
            out, ref = torch.empty_like(planes), torch.empty_like(planes)
            beam_gather_update(planes, kvg, src_rep, t, out)
            beam_gather_update_plain(planes, kvg, src_rep, t, ref)
            check(torch.equal(out, ref), f"beam_gather_update {tg}")
            for name in ("beam_gather_rows", "beam_gather_update"):
                errs.setdefault(name, []).append(0.0)
        torch.cuda.synchronize()
        for name, e in errs.items():
            rec = {"max_abs_err": max(e), "steps": len(e),
                   "path": "megarow" if megarow else "non_deferred"}
            results.append((name, tag, rec))
            print("path_shape_check", json.dumps({"kernel": name,
                                                  "case": tag, **rec}))
        torch.cuda.empty_cache()


SMALL_RUNS = (                   # (path, make_beam_search_fn kwargs)
    ("megarow", dict(kv_cache_quant=None)),
    ("megarow", dict(kv_cache_quant="int8")),
    ("megarow", dict(kv_cache_quant="int4")),
    # the megarow dataflows behind the reference's switches
    ("megarow", dict(kv_cache_quant="int4", qfuse=False)),
    ("megarow", dict(kv_cache_quant="int8", qfuse=False)),
    ("megarow", dict(kv_cache_quant="int4", qfuse=False,
                     kvg_quant_xla=True)),
    ("megarow", dict(kv_cache_quant="int4", fused_kvg=True)),
    ("megarow", dict(kv_cache_quant="int4", fused_kvg=True, qfuse=False)),
    ("megarow", dict(kv_cache_quant=None, fused_kvg=True)),
    ("megarow", dict(kv_cache_quant="int4", mxu_math=True)),
    ("megarow", dict(kv_cache_quant="int8", mxu_math=True)),
    ("deferred", dict(megarow=False, kv_cache_quant=None)),
    ("deferred", dict(megarow=False, kv_cache_quant="int8")),
    ("deferred", dict(megarow=False, kv_cache_quant="int8",
                      kvg_quant_xla=True)),
    ("deferred", dict(megarow=False, kv_cache_quant="int4")),
    ("non_deferred", dict(deferred=False)),
    ("write_attend", dict(use_pallas_gather=False)),
)


def small_agreement():
    """Phase 3: beam search through the kernels on the card vs the plain
    path on the CPU, tiny model, f32, on every path and cache."""
    import torch
    from ripor_tpu_torch.decode.beam import NEG_INF, make_beam_search_fn
    from ripor_tpu_torch.models import RiporModel, init_params, ripor_small
    from ripor_tpu_torch.trie import (build_trie, succinct_tables,
                                      tables_to_torch)
    cfg = ripor_small(M=8, K=16)
    sd = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    rng = np.random.default_rng(SEED)
    tables = succinct_tables(build_trie(rng.integers(0, 16, (300, 8)), 16))
    ids = rng.integers(3, 500, (3, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    out, secs = {}, {}
    for dev in ("cpu", "cuda"):
        model = RiporModel(cfg, device=dev)
        model.load_state_dict(sd)
        for i, (_, kw) in enumerate(SMALL_RUNS):
            t0 = time.monotonic()
            fn = make_beam_search_fn(cfg, 16, dtype=torch.float32,
                                     device=dev, **kw)
            out[dev, i] = [a.cpu().numpy() for a in fn(
                model, ids, mask, tables_to_torch(tables, dev))]
            secs[dev, i] = time.monotonic() - t0
    for i, (path, kw) in enumerate(SMALL_RUNS):
        (s0, c0, st0), (s1, c1, st1) = out["cpu", i], out["cuda", i]
        quant = kw.get("kv_cache_quant")
        kvg = " kvg int8" if kw.get("kvg_quant_xla") else ""
        flow = "".join(f" {k}={v}" for k, v in kw.items()
                       if k in ("qfuse", "fused_kvg", "mxu_math"))
        tag = f"{path} {quant or 'f32'}{kvg}{flow}"
        live = s0 > NEG_INF / 2
        check(live.all(), f"small agreement {tag}: every beam live")
        check(np.array_equal(c0[:, 0], c1[:, 0]),
              f"small agreement {tag}: top beam differs")
        if quant is None:
            check(np.array_equal(c0, c1) and np.array_equal(st0, st1),
                  f"small agreement {tag}: exact-cache codes/states differ")
            check(np.allclose(s0, s1, rtol=1e-4, atol=1e-4),
                  f"small agreement {tag}: scores differ by "
                  f"{np.abs(s0 - s1).max()}")
        print("small_agreement", json.dumps({
            "path": path, "cache": quant or "f32",
            "kvg_quant_xla": bool(kw.get("kvg_quant_xla")),
            "dataflow": flow.strip() or "default",
            "top_beam_equal": True,
            "max_abs_score_diff": float(np.abs(s0 - s1).max()),
            "cpu_s": secs["cpu", i], "cuda_s": secs["cuda", i]}))


def where_time_goes(label, search, unprofiled_s, shape=None):
    """Phases 5, 6 and 8: one B=8 decode (or, phase 8, one train step;
    ``shape`` then replaces the decode's batch and steps in the record)
    under torch.profiler — device time by kernel and the device's busy
    share of the wall time (the union of kernel intervals over the host
    clock around the call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = search()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    del out
    kern = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach = 0.0, float("-inf")
    by_name = {}
    for start, end, name in kern:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print("profile", json.dumps({
        "run": label, **(shape or {"batch": B, "steps": M}),
        "wall_ms": wall_s * 1e3, "unprofiled_wall_ms": unprofiled_s * 1e3,
        "device_events": len(kern),
        "device_busy_ms": busy_us / 1e3 if kern else "not measured",
        "device_busy_share": busy_us / 1e6 / wall_s if kern
        else "not measured",
        # the profiler slows the host, not the kernels: busy time over the
        # same decode's wall time without the profiler
        "device_busy_share_unprofiled": busy_us / 1e6 / unprofiled_s if kern
        else "not measured",
        "top": [{"kernel": n[:100], "ms": us / 1e3} for n, us in top]}))


MEGAROW_KERNELS = ("reorder_cache_all", "step_attention_seq",
                   "beam_gather_rows")
# the kernels on the staged core (csrc/attend_staged.cuh)
STAGED_KERNELS = ("step_attention_seq", "step_attend_reorder",
                  "step_attention_fused", "step_attention")


def make_world():
    """The full-width model and data of phases 4 and 6: ripor_base(M=32,
    K=256) with random bf16 weights from the seed, a 100,000-doc
    random-code corpus and its trie, 40 random queries."""
    import torch
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.models import init_params, ripor_base
    from ripor_tpu_torch.trie import build_trie

    cfg = ripor_base(M=M, K=K)
    t0 = time.monotonic()
    sd = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, K, (N_DOCS, M))
    trie = build_trie(codes, K)
    docids = [f"doc{i}" for i in range(N_DOCS)]
    words = [f"w{i}" for i in range(5000)]
    queries = [" ".join(rng.choice(words, rng.integers(3, 12)))
               for _ in range(40)]
    print("main_path_setup", json.dumps({
        "seconds": time.monotonic() - t0, "docs": N_DOCS,
        "groups": int(trie.num_groups), "trie_nodes": int(trie.num_internal)}))
    return dict(cfg=cfg, sd=sd, trie=trie, docids=docids, queries=queries,
                tok=HashTokenizer(), codes=codes, words=words, device="cuda")


def check_beams(tag, trie, scores, bcodes, state):
    """Every beam of a beam-1000 search is live and sits on a trie leaf
    whose group codes are its codes."""
    from ripor_tpu_torch.decode.beam import NEG_INF
    check((scores > NEG_INF / 2).all(), f"{tag}: dead beams at beam 1000")
    groups = -2 - state
    check((groups >= 0).all(), f"{tag}: live beam off a leaf")
    check(np.array_equal(trie.unique_codes[groups], bcodes),
          f"{tag}: beam codes differ from their trie group")
    return groups


def check_results(tag, res):
    """1000 results per query, finite scores that do not increase."""
    for r in res:
        check(len(r) == 1000, f"{tag}: {len(r)} results, not 1000")
        s = [v for _, v in r]
        check(all(np.isfinite(s)), f"{tag}: non-finite score")
        check(all(a >= b for a, b in zip(s, s[1:])),
              f"{tag}: scores increase")


def zero_launches():
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def need_launches(tag, kernels, total=None):
    """The launch counters since they were zeroed (the kernels that
    launched); each of ``kernels`` must have launched. Adds every count to
    ``total`` when given."""
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    counts = {k: n for k, n in KERNEL_LAUNCHES.items() if n}
    for k in kernels:
        check(counts.get(k, 0) > 0, f"{tag}: kernel {k} never launched")
    if total is not None:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return counts


def main_path(world, launches):
    """Phase 4: serve beam-1000 retrieval at t5-base through
    RetrievalEngine on the megarow path. Fills ``launches`` with this
    phase's launch counts."""
    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig

    cfg, sd, trie = world["cfg"], world["sd"], world["trie"]
    docids, queries, tok = world["docids"], world["queries"], world["tok"]
    valid = set(map(tuple, trie.unique_codes.tolist()))

    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    for quant, n_sync, n_async in (("int4", 16, 16), (None, 8, 0),
                                   ("int8", 8, 0)):
        torch.cuda.reset_peak_memory_stats()
        before = dict(KERNEL_LAUNCHES)
        t0 = time.monotonic()
        eng = RetrievalEngine(
            cfg, sd, tok, trie, docids,
            ServeConfig(num_beams=1000, topk=1000, batch_sizes=(1, 8),
                        kv_cache_quant=quant), device="cuda")
        warm_s = time.monotonic() - t0
        qs = queries[:n_sync]
        t0 = time.monotonic()
        res = eng.retrieve_batch(qs)
        sync_s = time.monotonic() - t0
        if n_async:
            eng.start()
            try:
                t0 = time.monotonic()
                futs = [eng.submit(q) for q in queries[n_sync:n_sync + n_async]]
                res += [f.result(timeout=600) for f in futs]
                async_s = time.monotonic() - t0
            finally:
                eng.stop()
        check_results(quant, res)
        # the beams behind one batch: live codes must be trie paths
        # (timed: one B=8 batch, host clock around work ending in a copy
        # to the host)
        ids, mask = tokenize_queries(tok, queries[:B], 64)
        t0 = time.monotonic()
        scores, bcodes, state = (a.cpu().numpy() for a in eng._fn(
            eng._model, ids, mask, eng._tables))
        decode_s = time.monotonic() - t0
        check_beams(quant, trie, scores, bcodes, state)
        check(all(tuple(c) in valid for c in bcodes.reshape(-1, M)[:4000]),
              f"{quant}: beam code not in the corpus")
        if quant == "int4":      # phase 6b holds its dataflows against it
            world["int4_b8"] = (scores, bcodes, state)
        if quant == "int4":
            where_time_goes("megarow int4", lambda: eng._fn(
                eng._model, ids, mask, eng._tables), decode_s)
        rec = {"cache": quant or "bf16", "warmup_s": warm_s,
               "sync_queries": n_sync, "sync_s": sync_s,
               "sync_qps": n_sync / sync_s,
               "decode_b8_s": decode_s,
               "ms_per_decode_step_b8": decode_s / M * 1e3,
               "max_memory_allocated_gb":
                   torch.cuda.max_memory_allocated() / 1e9,
               "launches": {k: KERNEL_LAUNCHES[k] - before[k]
                            for k in KERNEL_LAUNCHES}}
        if n_async:
            rec.update(async_queries=n_async, async_s=async_s,
                       async_qps=n_async / async_s)
        print("main_path", json.dumps(rec))
        del eng
        torch.cuda.empty_cache()
    for k in MEGAROW_KERNELS:
        launches[k] = KERNEL_LAUNCHES[k]
        check(launches[k] > 0, f"kernel {k} never launched on the main path")


# path, make_beam_search_fn kwargs, launches one B=8 search must make
OTHER_PATHS = (
    ("deferred int4", dict(megarow=False, kv_cache_quant="int4"),
     {"step_attend_reorder": M * L, "beam_gather_rows": M - 1}),
    ("deferred int8", dict(megarow=False, kv_cache_quant="int8"),
     {"step_attend_reorder": M * L, "beam_gather_rows": M - 1}),
    ("deferred bf16", dict(megarow=False),
     {"step_attend_reorder": M * L, "beam_gather_rows": M - 1}),
    ("non-deferred bf16", dict(deferred=False),
     {"step_attention_fused": M * L, "beam_gather_rows": M - 1,
      "beam_gather_update": M - 1}),
    ("write-then-attend bf16", dict(use_pallas_gather=False),
     {"step_attention": M * L, "beam_gather_blocks": M - 1}),
)


def other_paths(world, launches):
    """Phase 6: one B=8 beam-1000 search on each of the deferred
    per-layer, non-deferred and write-then-attend paths at phase 4's model, corpus and queries (after
    one warm-up search), with phase 4's checks and a profile; two more
    searches time it (median of three). Counters are zeroed just before
    the first timed search and read just after; it must show exactly its
    path's kernels. Adds those launches to ``launches``."""
    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.decode.beam import (expand_groups_to_docids,
                                             make_beam_search_fn)
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.trie import succinct_tables, tables_to_torch

    cfg, trie = world["cfg"], world["trie"]
    model = RiporModel(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(world["sd"])
    tables = tables_to_torch(succinct_tables(trie), "cuda")
    ids, mask = tokenize_queries(world["tok"], world["queries"][:B], 64)
    for tag, kw, expect in OTHER_PATHS:
        fn = make_beam_search_fn(cfg, 1000, device="cuda", **kw)

        def search():
            return fn(model, ids, mask, tables)

        search()                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0
        t0 = time.monotonic()
        scores, bcodes, state = (a.cpu().numpy() for a in search())
        times = [time.monotonic() - t0]
        counts = dict(KERNEL_LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts == {k: expect.get(k, 0) for k in counts},
              f"{tag}: launches {counts}, expected {expect}")
        groups = check_beams(tag, trie, scores, bcodes, state)
        check_results(tag, [list(zip(*expand_groups_to_docids(
            trie, groups[b], scores[b], 1000))) for b in range(B)])
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        # two more timed searches: the host clock of one search spreads
        # (the host is shared), the median is reported
        for _ in range(2):
            t0 = time.monotonic()
            search()[0].cpu()
            times.append(time.monotonic() - t0)
        decode_s = float(np.median(times))
        print("other_path", json.dumps({
            "path": tag, "batch": B, "decode_b8_s": decode_s,
            "decode_b8_s_runs": times,
            "ms_per_decode_step_b8": decode_s / M * 1e3,
            "qps_b8": B / decode_s, "max_memory_allocated_gb": peak_gb,
            "launches": counts}))
        where_time_goes(tag, search, decode_s)
        torch.cuda.empty_cache()


# the megarow dataflows behind the reference's switches, at phase 4's
# int4 search: make_beam_search_fn kwargs, launches one B=8 search must
# make, whether its codes, states and scores equal the default's bit for
# bit (tests/test_beam.py:508-573's bar)
DATAFLOWS = (
    ("qfuse off", dict(qfuse=False),
     {"reorder_cache_all_qinsert": M, "step_attention_seq": M * L,
      "beam_gather_rows": M - 1}, True),
    ("fused kvg", dict(fused_kvg=True),
     {"reorder_cache_all_fused": M, "step_attention_seq": M * L}, True),
    ("fused kvg, qfuse off", dict(fused_kvg=True, qfuse=False),
     {"reorder_cache_all_fused": M, "step_attention_seq": M * L}, True),
    ("mxu math", dict(mxu_math=True),
     {"reorder_cache_all": M, "step_attention_seq_mxu": M * L,
      "beam_gather_rows": M - 1}, False),
)


def dataflow_paths(world, launches):
    """Phase 6b: one B=8 beam-1000 search on each megarow dataflow of
    DATAFLOWS at phase 4's model, corpus, queries and int4 cache (after
    one warm-up search), with phase 4's checks; counters zeroed just
    before and read just after must show exactly its launches; two more
    searches time it (median of three). K1' and K1'' searches equal
    phase 4's default int4 search bit for bit; for K2' (its gate: phases
    2 and 3), the codes of the 1000 a query that are not among the
    default's. Adds the launches to ``launches``."""
    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.decode.beam import (expand_groups_to_docids,
                                             make_beam_search_fn)
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.trie import succinct_tables, tables_to_torch

    cfg, trie = world["cfg"], world["trie"]
    model = RiporModel(cfg, dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(world["sd"])
    tables = tables_to_torch(succinct_tables(trie), "cuda")
    ids, mask = tokenize_queries(world["tok"], world["queries"][:B], 64)
    ref = world["int4_b8"]
    for tag, kw, expect, same in DATAFLOWS:
        fn = make_beam_search_fn(cfg, 1000, kv_cache_quant="int4",
                                 device="cuda", **kw)
        fn(model, ids, mask, tables)              # warm-up
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.monotonic()
        out = tuple(a.cpu().numpy() for a in fn(model, ids, mask, tables))
        decode_s = time.monotonic() - t0
        counts = dict(KERNEL_LAUNCHES)
        check(counts == {k: expect.get(k, 0) for k in counts},
              f"{tag}: launches {counts}, expected {expect}")
        scores, bcodes, state = out
        groups = check_beams(tag, trie, scores, bcodes, state)
        check_results(tag, [list(zip(*expand_groups_to_docids(
            trie, groups[b], scores[b], 1000))) for b in range(B)])
        equal = all(np.array_equal(a, b) for a, b in zip(out, ref))
        if same:
            check(equal, f"{tag}: search differs from the default int4 "
                         f"search")
        moved = [len({tuple(c) for c in bcodes[b]}
                     - {tuple(c) for c in ref[1][b]}) for b in range(B)]
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        # two more timed searches, the median reported (as phase 6)
        times = [decode_s]
        for _ in range(2):
            t0 = time.monotonic()
            fn(model, ids, mask, tables)[0].cpu()
            times.append(time.monotonic() - t0)
        decode_s = float(np.median(times))
        print("dataflow_path", json.dumps({
            "dataflow": tag, "batch": B, "decode_b8_s": decode_s,
            "decode_b8_s_runs": times,
            "ms_per_decode_step_b8": decode_s / M * 1e3,
            "equal_to_default": equal, "codes_moved_per_query": moved,
            "launches": {k: v for k, v in counts.items() if v}}))
        torch.cuda.empty_cache()


def run_cli(argv, tag):
    """One call of the port's CLI in this process; echoes and returns its
    standard output."""
    import contextlib
    import io
    from ripor_tpu_torch.cli.main import main as cli_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"cli {tag}:", line)
    return out


def timing_line(out):
    """The retrieve_timing record a `retrieve` call printed."""
    line = next(ln for ln in out.splitlines()
                if ln.startswith("retrieve_timing "))
    return json.loads(line.split(" ", 1)[1])


def check_same_run(tag, got, want):
    """Two runs (or a run and engine results): the same qids, and per
    query the same docids in the same order with scores within 1e-6."""
    check(list(got) == list(want), f"{tag}: qids differ")
    for qid in want:
        g, w = list(got[qid]), list(want[qid])
        check([d for d, _ in g] == [d for d, _ in w],
              f"{tag}: {qid} docids or their order differ")
        err = max(abs(a - b) for (_, a), (_, b) in zip(g, w))
        check(err <= 1e-6, f"{tag}: {qid} scores differ by {err}")


def read_run(path):
    with open(path) as f:
        return {q: list(d.items()) for q, d in json.load(f).items()}


def mrr_qrel(results, qids):
    """Phase 7's qrel: for query q, the doc at rank r_q = 1 + (q mod 10)
    of ``results``, moved to the nearest rank (at most 10) whose score no
    other result shares, so trec's docid tie-break cannot move it. Returns
    (qrel, ranks)."""
    qrel, ranks = {}, []
    for q, (qid, res) in enumerate(zip(qids, results)):
        scores = [v for _, v in res]

        def untied(r):
            return sum(v == scores[r - 1] for v in scores) == 1
        want = 1 + q % 10
        r = min((r for r in range(1, 11) if untied(r)),
                key=lambda r: (abs(r - want), r))
        qrel[qid] = {res[r - 1][0]: 1}
        ranks.append(r)
    return qrel, ranks


def cli_phase(world, launches, tmp):
    """Phase 7: the main path through its entry points. A workspace written
    in ``tmp`` by the port's own functions (phase 4's model saved by save_params, its
    corpus as docid_to_smtid.json, a WordTokenizer, 16 queries in raw.tsv);
    ``retrieve`` at beam = topk = 1000 as a subprocess and in process
    (run.json equal to RetrievalEngine.retrieve_batch), ``--nranks 2`` and
    ``retrieve-merge`` (equal to the single run), ``evaluate`` (MRR@10
    equal to the constructed value), ``serve_http`` with an int4 cache (two
    POST /retrieve of 8 queries equal to retrieve_batch, GET /stats, a
    disabled /profile), and ffn_int8 (ffn_int8_check). Counters are
    zeroed before each part and read after it; the kernels of its path
    must have launched. Adds the in-process retrieve's and the ffn_int8
    searches' launches to ``launches``."""
    import http.client
    import os

    import torch
    from ripor_tpu_torch.data.datasets import save_docid_to_smtid
    from ripor_tpu_torch.data.tokenizer import WordTokenizer
    from ripor_tpu_torch.pipeline import load_tokenizer
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig, serve_http
    from ripor_tpu_torch.train import load_params, save_params

    cfg, trie, docids = world["cfg"], world["trie"], world["docids"]
    dev = world["device"]
    texts = world["queries"][:16]
    qids = [f"q{i}" for i in range(16)]

    ws = os.path.join(tmp, "ws")
    ckpt = os.path.join(ws, "checkpoints", "final")
    t0 = time.monotonic()
    save_params(ckpt, world["sd"], cfg)
    os.makedirs(os.path.join(tmp, "queries"))
    with open(os.path.join(tmp, "queries", "raw.tsv"), "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in zip(qids, texts))
    WordTokenizer.train(world["words"]).save(
        os.path.join(ws, "tokenizer.json"))
    save_docid_to_smtid(os.path.join(ws, "docid_to_smtid.json"), docids,
                        world["codes"])
    print("cli_workspace", json.dumps({
        "seconds": time.monotonic() - t0, "queries": len(qids),
        "params_pt_bytes": os.path.getsize(
            os.path.join(ckpt, "params.pt"))}))
    base = ["retrieve", "--workspace", ws,
            "--queries", os.path.join(tmp, "queries"),
            "--beam", "1000", "--topk", "1000", "--device", dev]
    torch.cuda.empty_cache()

    # the CLI as a user runs it: a process of its own (it builds the
    # trie and saves trie.npz; the kernels come from the build cache)
    t0 = time.monotonic()
    sub = subprocess.run(
        [sys.executable, "-m", "ripor_tpu_torch.cli.main", *base,
         "--run-name", "run_subprocess.json"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    for line in sub.stdout.splitlines():
        print("cli subprocess:", line)
    check(sub.returncode == 0, f"retrieve subprocess exit "
          f"{sub.returncode}: {sub.stderr[-2000:]}")
    sub_timing = timing_line(sub.stdout)
    sub_timing["process_s"] = time.monotonic() - t0

    zero_launches()
    out = run_cli(base, "in process")
    counts = need_launches("cli retrieve", MEGAROW_KERNELS)
    for k in MEGAROW_KERNELS:
        launches[k] = counts[k]
    timing = timing_line(out)
    run = read_run(os.path.join(ws, "run.json"))
    check(list(run) == qids and all(len(r) == 1000
                                    for r in run.values()),
          "cli run.json: not 16 queries of 1000 docs")
    check_results("cli run.json", list(run.values()))
    check_same_run("cli subprocess vs in process",
                   read_run(os.path.join(ws, "run_subprocess.json")),
                   run)
    print("cli_retrieve", json.dumps({
        "batch": 8, "beam": 1000, "topk": 1000, "in_process": timing,
        "subprocess": sub_timing, "launches": {
            k: counts[k] for k in MEGAROW_KERNELS}}))

    tok = load_tokenizer(os.path.join(ws, "tokenizer.json"))
    params = load_params(ckpt)
    eng = RetrievalEngine(cfg, params, tok, trie, docids,
                          ServeConfig(num_beams=1000, topk=1000,
                                      batch_sizes=(8,)), device=dev)
    want = eng.retrieve_batch(texts)
    del eng
    torch.cuda.empty_cache()
    check_same_run("cli run.json vs RetrievalEngine", run,
                   dict(zip(qids, want)))

    for rank in (0, 1):
        run_cli(base + ["--rank", str(rank), "--nranks", "2",
                        "--run-name", "run_shard.json"], f"rank {rank}")
    run_cli(["retrieve-merge", "--workspace", ws, "--nranks", "2",
             "--run-name", "run_shard.json"], "merge")
    merged = read_run(os.path.join(ws, "run_shard.json"))
    check_same_run("retrieve-merge vs single run",
                   {q: merged[q] for q in qids}, run)

    qrel, ranks = mrr_qrel(want, qids)
    qrel_path = os.path.join(tmp, "qrel.json")
    with open(qrel_path, "w") as f:
        json.dump(qrel, f)
    got = json.loads(run_cli(["evaluate", "--qrel", qrel_path, "--run",
                              os.path.join(ws, "run.json"),
                              "--metric", "mrr_10"], "evaluate"))
    expect = sum(1.0 / r for r in ranks) / len(ranks)
    check(got == {"mrr_10": expect},
          f"evaluate: {got}, constructed MRR@10 {expect}")
    print("cli_evaluate", json.dumps({"ranks": ranks, "mrr_10": expect}))

    # serve with --kv-quant int4 settings
    eng = RetrievalEngine(cfg, params, tok, trie, docids,
                          ServeConfig(num_beams=1000, topk=1000,
                                      batch_sizes=(8,),
                                      kv_cache_quant="int4",
                                      ckpt_dir=ckpt), device=dev)
    want4 = eng.retrieve_batch(texts)
    zero_launches()
    server = serve_http(eng, port=0, block=False)
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=600)
        got4 = []
        for part in (texts[:8], texts[8:]):
            conn.request("POST", "/retrieve",
                         body=json.dumps({"queries": part}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            check(resp.status == 200, f"POST /retrieve: {resp.status}")
            got4 += [[tuple(x) for x in r] for r in body["results"]]
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        stats = json.loads(resp.read())
        check(resp.status == 200 and stats["served"] >= 32,
              f"GET /stats: {resp.status} {stats}")
        conn.request("GET", "/profile?ms=10")
        resp = conn.getresponse()
        resp.read()
        check(resp.status == 403, f"disabled /profile: {resp.status}")
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    counts = need_launches("serve", MEGAROW_KERNELS)
    check_results("serve int4", got4)
    check_same_run("HTTP answers vs retrieve_batch",
                   dict(zip(qids, got4)), dict(zip(qids, want4)))
    print("cli_serve", json.dumps({
        "cache": "int4", "requests": 2, "queries": 16,
        "stats": {k: stats[k] for k in ("served", "qps", "p50_s",
                                        "batch_hist")},
        "launches": {k: counts[k] for k in MEGAROW_KERNELS}}))
    del eng, params
    torch.cuda.empty_cache()

    ffn_int8_check(world, launches)


def beam_agreement(a, b):
    """How far search b moves from search a (scores, codes, states as
    numpy): per query, whether the top beams agree and how many codes of
    the smaller live set the other lacks; the largest |score| change by
    rank and its ratio to rtol 0.05 / atol 0.25."""
    from ripor_tpu_torch.decode.beam import NEG_INF
    (s0, c0, _), (s1, c1, _) = a, b
    live = (s0 > NEG_INF / 2) & (s1 > NEG_INF / 2)
    err = np.abs(s1[live] - s0[live])
    diff = []
    for q in range(len(s0)):
        set0 = {tuple(r) for r, v in zip(c0[q], s0[q]) if v > NEG_INF / 2}
        set1 = {tuple(r) for r, v in zip(c1[q], s1[q]) if v > NEG_INF / 2}
        diff.append(min(len(set0), len(set1)) - len(set0 & set1))
    return {"top_beam_equal": [bool(np.array_equal(c0[q, 0], c1[q, 0]))
                               for q in range(len(s0))],
            "code_set_diff": diff, "max_abs_score_diff": float(err.max()),
            "max_diff_over_bar": float(
                (err / (0.25 + 0.05 * np.abs(s0[live]))).max())}


def ffn_int8_check(world, launches):
    """Phase 7, ffn_int8 on the card. (a) At tests/test_beam.py:646-672's
    geometry (ripor_small(M=6, K=8), 40 docs, 5 beams, f32, 3 cache
    segments): the megarow and deferred ffn_int8 searches against the
    exact non-deferred search at that test's bar: top beam equal, live
    scores within rtol 0.05 / atol 0.25, code sets differing by at most
    one. (b) At full width (phase 4's model, B=8, beam 1000, bf16): one
    ffn_int8 search on each path, every beam live on a trie leaf and its
    path's kernels launched (counters zeroed just before, read just
    after), with how far it moves from the exact megarow search beside
    how far two exact paths (megarow, write-then-attend) move from each
    other. (a)'s bar is not held at (b): at beam 1000 in bf16 two exact
    paths already differ by more."""
    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.models import (RiporModel, init_params,
                                        ripor_small)
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.trie import (build_trie, succinct_tables,
                                      tables_to_torch)

    dev = world["device"]
    paths = (("megarow", dict(megarow=True), MEGAROW_KERNELS),
             ("deferred", dict(megarow=False),
              ("step_attend_reorder", "beam_gather_rows")))

    # (a) the JAX package's bar at its geometry
    cfg = ripor_small(M=6, K=8)
    model = RiporModel(cfg, device=dev)
    model.load_state_dict(init_params(
        cfg, torch.Generator().manual_seed(SEED), device="cpu"))
    rng = np.random.default_rng(SEED)
    tables = tables_to_torch(succinct_tables(
        build_trie(rng.integers(0, 8, (40, 6)), 8)), dev)
    ids = rng.integers(1, 100, (2, 10)).astype(np.int32)

    def small(**kw):
        fn = make_beam_search_fn(cfg, 5, dtype=torch.float32, device=dev,
                                 cache_segments=3, **kw)
        return [a.cpu().numpy() for a in fn(model, ids, np.ones_like(ids),
                                            tables)]

    exact = small(deferred=False)
    for tag, kw, _ in paths:
        rec = beam_agreement(exact, small(ffn_int8=True, **kw))
        print("ffn_int8_bar", json.dumps({"path": tag, "geometry":
                                          "ripor_small M=6 K=8, 5 beams, "
                                          "f32", **rec}))
        check(all(rec["top_beam_equal"]), f"ffn_int8 {tag}: top beam")
        check(rec["max_diff_over_bar"] <= 1.0,
              f"ffn_int8 {tag}: scores beyond rtol 0.05 / atol 0.25")
        check(max(rec["code_set_diff"]) <= 1,
              f"ffn_int8 {tag}: code sets differ by {rec['code_set_diff']}")

    # (b) full width
    cfg = world["cfg"]
    model = RiporModel(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(world["sd"])
    tables = tables_to_torch(succinct_tables(world["trie"]), dev)
    ids, mask = tokenize_queries(world["tok"], world["queries"][:B], 64)

    def search(**kw):
        fn = make_beam_search_fn(cfg, 1000, device=dev, **kw)
        return [a.cpu().numpy() for a in fn(model, ids, mask, tables)]

    exact = search()
    print("ffn_int8_noise_floor", json.dumps({
        "exact megarow vs exact write-then-attend": beam_agreement(
            exact, search(use_pallas_gather=False))}))
    for tag, kw, kernels in paths:
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0
        got = search(ffn_int8=True, **kw)
        counts = dict(KERNEL_LAUNCHES)
        for k in kernels:
            check(counts[k] > 0, f"ffn_int8 {tag}: kernel {k} never launched")
            launches[k] = launches.get(k, 0) + counts[k]
        check_beams(f"ffn_int8 {tag}", world["trie"], *got)
        print("ffn_int8", json.dumps({
            "path": tag, "batch": B, "beam": 1000,
            "vs_exact_megarow": beam_agreement(exact, got),
            "launches": {k: counts[k] for k in kernels}}))
    del model
    torch.cuda.empty_cache()


# ---- phase 8: training ----

TRAIN_B, TRAIN_LQ, TRAIN_PREFIXES = 16, 64, (4, 8, 16)
TRAIN_LOSS = "t5seq_aq_encoder_lng_knp_margin_mse"


def train_step_flops(t5, b, lq, m):
    """Operations of one lng_knp_margin_mse step as the port runs it: the
    encoder once over b x lq tokens, the decoder twice (pos and neg codes)
    over b x m, with their matmuls and attention products; 2 operations a
    multiply-add, and the backward twice the forward."""
    d, f, inner = t5.d_model, t5.d_ff, t5.inner_dim
    enc = t5.num_layers * b * (lq * (4 * d * inner + 2 * d * f)
                               + 2 * lq * lq * inner)
    dec = t5.num_decoder_layers * b * (
        m * (6 * d * inner + 2 * d * f) + lq * 2 * d * inner
        + 2 * m * m * inner + 2 * m * lq * inner)
    return 3 * 2 * (enc + 2 * dec)


def write_trainset(path, qids, n, rng):
    """A synthetic teacher-score trainset over phase 4's corpus: n lines,
    each a query, a positive and 3 negatives with descending scores, and
    per-prefix scores for prefixes 4, 8 and 16."""
    with open(path, "w") as f:
        for i in range(n):
            docs = rng.choice(N_DOCS, 4, replace=False)
            rec = {"qid": qids[i % len(qids)],
                   "docids": [f"doc{j}" for j in docs],
                   "scores": sorted((rng.standard_normal(4) * 5).tolist(),
                                    reverse=True)}
            for p in TRAIN_PREFIXES:
                rec[f"smtid_{p}_scores"] = (rng.standard_normal(4)
                                            * p / 4).tolist()
            f.write(json.dumps(rec) + "\n")


def param_agreement(got, want, rtol=1e-5, atol=1e-6, steady=None):
    """Max |got - want| over all params, the share of entries outside
    rtol/atol, and the share bit-equal. ``steady``: per param a mask of
    the entries to count apart (``steady_loose_share``)."""
    import torch
    worst, loose, equal, n, s_loose, s_n = 0.0, 0, 0, 0, 0, 0
    for k, w in want.items():
        w = w.detach()
        g = got[k].detach().to(w.device)
        worst = max(worst, float((g - w).abs().max()))
        far = ~torch.isclose(g, w, rtol=rtol, atol=atol)
        loose += int(far.sum())
        equal += int((g == w).sum())
        n += w.numel()
        if steady is not None:
            s_loose += int((far & steady[k]).sum())
            s_n += int(steady[k].sum())
    out = {"max_abs": worst, "loose_share": loose / n,
           "equal_share": equal / n, "entries": n}
    if steady is not None:
        out.update(steady_entries=s_n, steady_loose_share=s_loose / s_n)
    return out


def train_batches(world, tmp):
    """Phase 8's batches (B=16): MarginMSECollator over the synthetic
    trainset ``tmp/train.jsonl`` on phase 7's workspace and queries."""
    import os

    from ripor_tpu_torch.data.collators import (MarginMSECollator,
                                                batches_from_teacher_examples)
    from ripor_tpu_torch.data.datasets import (Collection,
                                               TeacherScoreExamples)
    from ripor_tpu_torch.pipeline import load_tokenizer

    examples = TeacherScoreExamples(os.path.join(tmp, "train.jsonl"))
    check(examples.prefix_lengths_present() == TRAIN_PREFIXES,
          "8b: prefix scores missing")
    coll = MarginMSECollator(
        load_tokenizer(os.path.join(tmp, "ws", "tokenizer.json")),
        Collection(os.path.join(tmp, "queries")),
        dict(zip(world["docids"], world["codes"])), max_length=TRAIN_LQ,
        prefix_lengths=TRAIN_PREFIXES)
    return list(batches_from_teacher_examples(examples, coll, TRAIN_B,
                                              seed=SEED))


def train_phase(world, tmp):
    """Phase 8: training at full t5-base width and depth
    (ripor_base(M=32, K=256), 12 + 12 layers, float32 params and compute,
    dropout 0.1), loss lng_knp_margin_mse. (a) One step, dropout off, on
    the card and on the CPU from the same params: losses, grad_norm and
    updated params agree. (b) Trainer.run: 2 warm-up and 8 timed steps
    at B=16 from MarginMSECollator over a synthetic trainset (ms a step,
    examples/s, tokens/s, MFU against the float32 peak, peak memory, the
    busy share of one profiled step), then grad_accum=2 on 2 x 8. (c) 4
    uninterrupted steps against 2, a checkpoint, a new Trainer and 2
    more. (d) ``train --config`` as a subprocess on phase 7's workspace
    (init_checkpoint its params, 64 examples, B=16, 4 steps), then
    ``retrieve`` of the trained checkpoint with phase 7's checks."""
    import dataclasses
    import os

    import torch
    from ripor_tpu_torch.data.datasets import Collection
    from ripor_tpu_torch.models import RiporModel, init_params, ripor_base
    from ripor_tpu_torch.train import TrainConfig, Trainer, load_params

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; phase 8 trains in float32")
    print("train_precision", json.dumps({
        "params": "float32", "compute": "float32",
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}))
    cfg = ripor_base(M=M, K=K)
    t5 = cfg.t5
    check(t5.dropout_rate == 0.1, "t5-base dropout is not 0.1")
    rng = np.random.default_rng(SEED + 8)
    t0 = time.monotonic()
    sd = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    tcfg = TrainConfig(loss_type=TRAIN_LOSS)
    init_s = time.monotonic() - t0
    codes = world["codes"]

    # (a) one step, dropout off, card against CPU
    pick = rng.integers(0, N_DOCS, (2, 2))
    batch = {"query_ids": rng.integers(1, t5.vocab_size, (2, TRAIN_LQ)
                                       ).astype(np.int32),
             "query_mask": np.ones((2, TRAIN_LQ), np.int32),
             "pos_codes": codes[pick[:, 0]].astype(np.int32),
             "neg_codes": codes[pick[:, 1]].astype(np.int32)}
    for key in ["teacher"] + [f"smtid_{p}_teacher" for p in TRAIN_PREFIXES]:
        for side in ("pos", "neg"):
            batch[f"{key}_{side}_score"] = (rng.standard_normal(2) * 5
                                            ).astype(np.float32)
    det = dataclasses.replace(cfg, t5=dataclasses.replace(t5,
                                                          dropout_rate=0.0))
    out = {}
    for dev in ("cpu", "cuda"):
        model = RiporModel(det, device=dev)
        trainer = Trainer(model, tcfg, sd)
        t0 = time.monotonic()
        _, metrics = trainer.run([batch])
        metrics = {k: float(v) for k, v in metrics.items()}
        out[dev] = (metrics, {k: v.detach().cpu()
                              for k, v in model.state_dict().items()},
                    time.monotonic() - t0)
        if dev == "cpu":
            # entries whose clipped gradient is at least 100x Adam's eps:
            # there one step moves each copy by ~lr in the same direction
            scale = min(1.0, tcfg.grad_clip / metrics["grad_norm"])
            steady = {k: p.grad.abs() * scale >= 1e-6
                      for k, p in model.named_parameters()}
        del trainer, model
    torch.cuda.empty_cache()
    (mc, pc, cpu_s), (mg, pg, gpu_s) = out["cpu"], out["cuda"]
    want_keys = {"rank", "rank_4", "rank_8", "rank_16", "loss", "grad_norm"}
    check(set(mc) == set(mg) == want_keys, f"phase 8a metrics {sorted(mg)}")
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
    agree = param_agreement(pg, pc, steady=steady)
    moved = param_agreement(pc, sd)
    print("train_parity", json.dumps({
        "batch": 2, "query_tokens": TRAIN_LQ, "codes": M,
        "prefixes": TRAIN_PREFIXES, "dropout": 0.0, "lr": tcfg.learning_rate,
        "cpu": mc, "cuda": mg, "rel_diff": rel, "params": agree,
        "params_moved_share": 1.0 - moved["equal_share"],
        "cpu_step_s": cpu_s, "cuda_step_s": gpu_s, "init_s": init_s}))
    # the tolerance (measured on the card; PERF.md, training): losses within
    # 1e-4 and grad_norm within 1e-3 relative (f32 sums in another order
    # through 24 layers: grads agree to ~3e-4 of their tensor's largest
    # entry); updated params at most 2 lr apart (one Adam step's reach),
    # at most 1 % of entries outside rtol 1e-5 / atol 1e-6, and almost
    # none (1e-6) among the entries whose clipped gradient is at least
    # 100x Adam's eps — the loose entries are those near eps, where
    # Adam's g / (|g| + eps) turns gradient noise into update noise
    check(all(np.isfinite(v) for v in mg.values()), "8a: non-finite metric")
    check(max(rel[k] for k in rel if k != "grad_norm") <= 1e-4
          and rel["grad_norm"] <= 1e-3, f"8a: card and CPU differ: {rel}")
    check(agree["max_abs"] <= 2 * tcfg.learning_rate + 1e-6
          and agree["loose_share"] <= 1e-2
          and agree["steady_loose_share"] <= 1e-6,
          f"8a: updated params differ: {agree}")
    del out, pc, pg, steady

    # (b) speed: Trainer.run over collated batches
    ws = os.path.join(tmp, "ws")
    qdir = os.path.join(tmp, "queries")
    trainset = os.path.join(tmp, "train.jsonl")
    write_trainset(trainset, Collection(qdir).ids, 10 * TRAIN_B, rng)
    batches = train_batches(world, tmp)
    check(len(batches) == 10, f"8b: {len(batches)} batches")
    flops = train_step_flops(t5, TRAIN_B, TRAIN_LQ, M)
    positions = TRAIN_B * (TRAIN_LQ + 2 * M)

    def timed_run(tc, bs, label):
        logs = []
        model = RiporModel(cfg, device="cuda")
        trainer = Trainer(model, tc, sd,
                          log_fn=lambda m, s: logs.append((s, m)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        trainer.run(bs, seed=SEED, log_every=1, flops_per_step=flops)
        wall_s = time.monotonic() - t0
        check([s for s, _ in logs] == list(range(1, len(bs) + 1)),
              f"{label}: steps {[s for s, _ in logs]}")
        for s, m in logs:
            check({"rank", "rank_4", "rank_8", "rank_16"} <= set(m),
                  f"{label}: step {s} lacks a prefix loss: {sorted(m)}")
            check(all(np.isfinite(m[k]) for k in
                      ("loss", "rank", "rank_4", "rank_8", "rank_16",
                       "grad_norm")), f"{label}: step {s} not finite: {m}")
        last = logs[-1][1]
        check(last["steps"] == len(bs) - 2, f"{label}: timed {last}")
        p50 = last["p50_s"]
        rec = {"run": label, "batch": TRAIN_B, "grad_accum": tc.grad_accum,
               "steps_warmup": 2, "steps_timed": last["steps"],
               "ms_per_step_median": p50 * 1e3,
               "ms_per_step_mean": last["mean_s"] * 1e3,
               "ms_per_step_p95": last["p95_s"] * 1e3,
               "examples_per_s": TRAIN_B / p50,
               "positions_per_step": positions,
               "tokens_per_s": positions / p50,
               "real_query_tokens_per_step": float(np.mean(
                   [b["query_mask"].sum() for b in bs])),
               "flops_per_step": flops,
               "mfu_f32": flops / p50 / F32_FLOPS,
               "step_timer_mfu": last.get("mfu"),
               "peak_flops_f32": F32_FLOPS,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "wall_s": wall_s,
               "losses_first": {k: logs[0][1][k] for k in
                                ("loss", "rank", "rank_4", "rank_8",
                                 "rank_16", "grad_norm")},
               "losses_last": {k: last[k] for k in
                               ("loss", "rank", "rank_4", "rank_8",
                                "rank_16", "grad_norm")}}
        return trainer, rec

    trainer, rec = timed_run(tcfg, batches, "train B=16")
    one = batches[0]

    def one_step():
        return trainer.run([one], seed=SEED, log_every=10 ** 9,
                           batches_start=trainer.state.step)
    one_step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    one_step()
    torch.cuda.synchronize()
    where_time_goes("train lng_knp B=16", one_step, time.monotonic() - t0,
                    {"batch": TRAIN_B, "steps": 1})
    print("train_speed", json.dumps(rec))
    del trainer
    torch.cuda.empty_cache()
    half = TRAIN_B // 2
    micro = [{k: v.reshape((2, half) + v.shape[1:]) for k, v in b.items()}
             for b in batches]
    trainer, rec = timed_run(dataclasses.replace(tcfg, grad_accum=2), micro,
                             "train 2 x 8 grad_accum=2")
    print("train_speed", json.dumps(rec))
    del trainer
    torch.cuda.empty_cache()

    # (c) resume: 4 steps against 2 + checkpoint + a new Trainer + 2
    ck = os.path.join(tmp, "train_ck")
    model = RiporModel(cfg, device="cuda")
    full, _ = Trainer(model, tcfg, sd).run(batches[:4], seed=SEED)
    full = {k: v.detach().clone() for k, v in full.params.items()}
    del model
    t0 = time.monotonic()
    Trainer(RiporModel(cfg, device="cuda"), tcfg, sd, checkpoint_dir=ck,
            save_steps=2).run(batches[:2], seed=SEED)
    torch.cuda.empty_cache()
    t2 = Trainer(RiporModel(cfg, device="cuda"), tcfg, sd, checkpoint_dir=ck,
                 save_steps=2)
    check(t2.resume_step == 2, f"8c: resumed at {t2.resume_step}")
    resumed, _ = t2.run(batches[:4], seed=SEED)
    resume_s = time.monotonic() - t0
    agree = param_agreement(resumed.params, full)
    print("train_resume", json.dumps({
        "steps": 4, "checkpoint_at": 2, "params": agree,
        "seconds_with_checkpoint": resume_s,
        "state_bytes": os.path.getsize(os.path.join(ck, "2", "state.pt"))}))
    check(agree["max_abs"] <= 2 * tcfg.learning_rate
          and agree["loose_share"] <= 1e-3,
          f"8c: resumed run differs: {agree}")
    del t2, resumed, full
    torch.cuda.empty_cache()

    # (d) the entry points: train --config, then retrieve the checkpoint
    train64 = os.path.join(tmp, "train64.jsonl")
    with open(trainset) as f, open(train64, "w") as g:
        g.writelines(f.readlines()[:4 * TRAIN_B])
    ckpt = os.path.join(ws, "checkpoints", "final")
    conf = os.path.join(tmp, "train_config.json")
    with open(conf, "w") as f:
        json.dump({"workspace": ws, "queries_dir": qdir,
                   "examples_path": train64, "loss_type": TRAIN_LOSS,
                   "model_config": os.path.join(ckpt, "config.json"),
                   "init_checkpoint": ckpt, "batch_size": TRAIN_B,
                   "max_length": TRAIN_LQ, "phase_name": "trained"}, f)
    t0 = time.monotonic()
    sub = subprocess.run(
        [sys.executable, "-m", "ripor_tpu_torch.cli.main", "train",
         "--config", conf],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    train_wall = time.monotonic() - t0
    for line in sub.stdout.splitlines():
        print("cli train:", line)
    check(sub.returncode == 0, f"train subprocess exit {sub.returncode}: "
          f"{sub.stderr[-2000:]}")
    trained = load_params(os.path.join(ws, "checkpoints", "trained"))
    check(trained["encoder.layers.0.attn.q.weight"].dtype == torch.float32,
          "8d: the trained checkpoint is not float32")
    check(not torch.equal(trained["encoder.layers.0.attn.q.weight"].to(
        torch.bfloat16), world["sd"]["encoder.layers.0.attn.q.weight"].cpu()),
        "8d: train --config did not move the params")
    del trained
    out = run_cli(["retrieve", "--workspace", ws, "--queries", qdir,
                   "--phase", "trained", "--beam", "1000", "--topk", "1000",
                   "--run-name", "run_trained.json", "--device", "cuda"],
                  "trained")
    run = read_run(os.path.join(ws, "run_trained.json"))
    check(len(run) == 16 and all(len({d for d, _ in r}) == 1000
                                 for r in run.values()),
          "8d: not 16 queries of 1000 distinct docs")
    check_results("8d run_trained.json", list(run.values()))
    print("train_cli", json.dumps({
        "examples": 4 * TRAIN_B, "batch": TRAIN_B, "steps": 4,
        "train_wall_s": train_wall,
        "train_timing": json.loads(next(
            ln for ln in sub.stdout.splitlines()
            if ln.startswith("train_timing ")).split(" ", 1)[1]),
        "retrieve_timing": timing_line(out)}))
    torch.cuda.empty_cache()


# ---- phase 9: the DocID build and dense retrieval ----

# The full-width run of phase 9. A rehearsal at a tiny size on the CPU
# passes a smaller copy (every function below reads its sizes from here).
P9 = dict(
    device="cuda",
    rq_rows=1_000_000, rq_dim=F, rq_M=M, rq_K=K, rq_iters=25,
    rq_centres=4096, rq_noise=0.3, rq_encode_beam=4, sub_rows=20_000,
    stream_rows=2_000_000, stream_batch=1_000_000, stream_M=2,
    stream_iters=3,
    corpus_rows=8_841_823,          # MS MARCO passages
    check_rows=1_000_000, dense_batches=(1, 8, 64), dense_topk=1000,
    dense_reps=5,
    cli_docs=100_000, cli_doc_len=32, cli_M=M, cli_K=K, cli_beam=1000,
    cli_topk=100, dev_eval_beams=100,
)


def peak_gb(dev):
    import torch
    if torch.device(dev).type != "cuda":
        return "not measured"
    return torch.cuda.max_memory_allocated() / 1e9


def reset_peak(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def greedy_mse(x, books, block=262_144):
    """Mean squared residual norm after each stage of ``books`` [M, K, d]
    (numpy), the greedy residuals train_rq fits: a list of M + 1 numbers,
    the first that of x itself. Computed on x's device in blocks."""
    import torch
    from ripor_tpu_torch.quantize import assign_codes
    bt = torch.as_tensor(books, device=x.device)
    sums = np.zeros(len(books) + 1)
    for s in range(0, x.shape[0], block):
        r = x[s:s + block].to(torch.float32).clone()
        sums[0] += float(torch.sum(r * r))
        for m in range(len(books)):
            r -= bt[m][assign_codes(r, bt[m])]
            sums[m + 1] += float(torch.sum(r * r))
    return list(sums / x.shape[0])


def gaussian_rows(n, d, centres, noise, g, dev):
    """[n, d] float32 rows on ``dev`` around ``centres`` random centres
    (data with cluster structure for k-means), drawn from ``g``."""
    import torch
    c = torch.randn(centres, d, generator=g, device=dev)
    a = torch.randint(0, centres, (n,), generator=g, device=dev)
    x = c[a]
    x += noise * torch.randn(n, d, generator=g, device=dev)
    return x


def docid_build(sz):
    """Phase 9 (a): RQ DocIDs at full width. train_rq(M=32, K=256, 25
    k-means iterations) on 1,000,000 x 768 float32 rows made on the card
    (a mixture of 4096 Gaussian centres), in device memory; rq_encode with
    beam 4. Checks: the greedy reconstruction MSE falls at every stage;
    re-encoding a 20,000-row slice gives the same codes, and rq_decode of
    them on the host equals their reconstruction on the card; one k-means
    stage on a 20,000-row subset, on the card and on the CPU from the same
    k-means++ centroids, agrees (assignments >= 99.9 % equal, centroids
    within 1e-4 of their scale); the share of unique smtids. Then the
    streamed route (batch = 1,000,000) on 2,000,000 host rows at M=2 with
    3 iterations (a cut of M and iterations: the route, not the fit)."""
    import torch
    from ripor_tpu_torch.quantize import rq_decode, rq_encode, train_rq
    from ripor_tpu_torch.quantize.kmeans import _kmeanspp_init, _lloyd_step
    from ripor_tpu_torch.quantize.rq import _rq_beam_encode

    dev = sz["device"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = gaussian_rows(sz["rq_rows"], sz["rq_dim"], sz["rq_centres"],
                      sz["rq_noise"], g, dev)
    reset_peak(dev)
    t0 = time.monotonic()
    books = train_rq(x, M=sz["rq_M"], K=sz["rq_K"],
                     kmeans_iters=sz["rq_iters"],
                     generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    sync(dev)
    train_s = time.monotonic() - t0
    train_peak = peak_gb(dev)
    reset_peak(dev)
    t0 = time.monotonic()
    codes = rq_encode(books, x, beam=sz["rq_encode_beam"], device=dev)
    encode_s = time.monotonic() - t0
    encode_peak = peak_gb(dev)
    mse = greedy_mse(x, books.codebooks)
    check(all(a > b for a, b in zip(mse, mse[1:])),
          f"rq: greedy MSE does not fall at every stage: {mse}")
    n20 = min(sz["sub_rows"], sz["rq_rows"])
    c20, _ = _rq_beam_encode(
        x[:n20], torch.as_tensor(books.codebooks, device=dev),
        sz["rq_encode_beam"])
    check(np.array_equal(c20.cpu().numpy(), codes[:n20]),
          "rq: re-encoding a slice gives other codes")
    # rq_decode on the host against the same reconstruction on the card
    bt = torch.as_tensor(books.codebooks, device=dev)
    on_card = bt[torch.arange(bt.shape[0], device=dev)[None], c20.long()]
    on_card = on_card.sum(dim=1).cpu().numpy()
    recon = rq_decode(books, codes[:n20])
    dec_diff = float(np.abs(recon - on_card).max() / np.abs(recon).max())
    check(dec_diff <= 1e-5, f"rq: rq_decode vs the card's sums {dec_diff}")
    del bt, on_card
    uniq = int(torch.unique(torch.as_tensor(codes, device=dev),
                            dim=0).shape[0])

    # one stage, card against CPU, from the same k-means++ centroids
    sub = x[:n20].contiguous()
    c0 = _kmeanspp_init(sub, sz["rq_K"], g)
    cd, cc, sub_c = c0, c0.cpu(), sub.cpu()
    gd = torch.Generator(device=dev).manual_seed(SEED)
    gc = torch.Generator().manual_seed(SEED)
    empty = 0
    for _ in range(sz["rq_iters"]):
        cd, ad = _lloyd_step(sub, cd, gd)
        cc, ac = _lloyd_step(sub_c, cc, gc)
        empty += int((torch.bincount(ac, minlength=sz["rq_K"]) == 0).sum())
    agree = float((ad.cpu() == ac).float().mean())
    cdiff = float((cd.cpu() - cc).abs().max() / cc.abs().max())
    check(empty == 0, f"rq stage vs CPU: {empty} empty clusters re-seeded "
          "(the two routes' draws differ)")
    check(agree >= 0.999, f"rq stage vs CPU: assignments {agree} equal")
    check(cdiff <= 1e-4, f"rq stage vs CPU: centroids {cdiff} apart")
    print("docid_build", json.dumps({
        "rows": sz["rq_rows"], "dim": sz["rq_dim"], "M": sz["rq_M"],
        "K": sz["rq_K"], "kmeans_iters": sz["rq_iters"],
        "train_s": train_s, "s_per_stage": train_s / sz["rq_M"],
        "train_peak_gb": train_peak, "encode_beam": sz["rq_encode_beam"],
        "encode_s": encode_s, "encode_peak_gb": encode_peak,
        "greedy_mse_by_stage": mse, "unique_smtids": uniq,
        "unique_share": uniq / sz["rq_rows"],
        "decode_rel_diff": dec_diff,
        "slice_vs_cpu": {"rows": n20, "assign_equal": agree,
                         "centroid_rel_diff": cdiff}}))
    del x, sub, sub_c, c20
    reset_peak(dev)

    # the streamed route: host rows, device batches
    xs = gaussian_rows(sz["stream_rows"], sz["rq_dim"], sz["rq_centres"],
                       sz["rq_noise"], g, dev).cpu().numpy()
    t0 = time.monotonic()
    sbooks = train_rq(xs, M=sz["stream_M"], K=sz["rq_K"],
                      kmeans_iters=sz["stream_iters"],
                      generator=torch.Generator(device=dev).manual_seed(SEED),
                      batch=sz["stream_batch"], device=dev)
    stream_s = time.monotonic() - t0
    smse = greedy_mse(torch.as_tensor(xs[:sz["stream_batch"]], device=dev),
                      sbooks.codebooks)
    check(all(a > b for a, b in zip(smse, smse[1:])),
          f"rq streamed: MSE does not fall at every stage: {smse}")
    print("docid_build_streamed", json.dumps({
        "rows": sz["stream_rows"], "batch": sz["stream_batch"],
        "M": sz["stream_M"], "kmeans_iters": sz["stream_iters"],
        "seconds": stream_s, "s_per_stage": stream_s / sz["stream_M"],
        "greedy_mse_first_batch": smse, "peak_gb": peak_gb(dev)}))
    del xs
    return codes


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def topk_sets_agree(s_got, i_got, s_ref, i_ref, rtol=1e-5):
    """Per query, the same indices apart from ties: the index sets agree
    outside the docs whose reference score is within ``rtol`` of the
    k-th score, and the scores agree within ``rtol``."""
    worst = 0.0
    for sg, ig, sr, ir in zip(s_got, i_got, s_ref, i_ref):
        kth = sr[-1]
        tol = rtol * max(1.0, abs(kth))
        firm_ref = {int(j) for j, v in zip(ir, sr) if v > kth + tol}
        if not firm_ref <= set(int(j) for j in ig):
            return False, worst
        worst = max(worst, float(np.max(np.abs(sg - sr)
                                         / np.maximum(1.0, np.abs(sr)))))
    return worst <= rtol, worst


def dense_serving(world, sz):
    """Phase 9 (b): DenseEngine at MS MARCO scale. An 8,841,823 x 768
    corpus in bf16 (13.58 GB) made on the card from the seed, and its
    Int8Corpus; phase 4's ripor_base model (random bf16 weights) as the
    query encoder; topk 1000 in batches of 1, 8 and 64. Checks on a
    1,000,000-row slice against a plain f32 reference (f32 products of
    the same bf16 values, TF32 off): the bf16 route's indices equal apart
    from ties, scores within 1e-5; int8 at tests/test_eval.py's bar (top-1
    equal, top-10 overlap >= 0.9), its top-1 allowed to differ only
    where the int8 error bound covers the lead of the reference's best.
    Every answer finite and non-increasing.
    Times: ms per batch and q/s (median of 5) of retrieve_batch and of
    dense_topk alone, beside the bound (the corpus bytes over 3.35 TB/s);
    the busy share of one profiled B=64 batch; peak memory."""
    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.evaluation.retriever import (Int8Corpus,
                                                      dense_topk,
                                                      device_corpus)
    from ripor_tpu_torch.quantize.kmeans import exact_f32
    from ripor_tpu_torch.serve import DenseEngine, ServeConfig

    dev = sz["device"]
    n, d, k = sz["corpus_rows"], world["cfg"].t5.d_model, sz["dense_topk"]
    reset_peak(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    t0 = time.monotonic()
    corpus = torch.empty(n, d, dtype=torch.bfloat16, device=dev)
    for s in range(0, n, 1_000_000):
        corpus[s:s + 1_000_000] = torch.randn(
            min(1_000_000, n - s), d, generator=g, device=dev)
    c8 = device_corpus(corpus, dtype=torch.int8)
    sync(dev)
    make_s = time.monotonic() - t0
    docids = [f"p{i}" for i in range(n)]
    rng = np.random.default_rng(SEED + 9)
    queries = [" ".join(rng.choice(world["words"], rng.integers(3, 12)))
               for _ in range(max(sz["dense_batches"]))]
    for tag, corp in (("bf16", corpus), ("int8", c8)):
        cbytes = (nbytes(corp) if isinstance(corp, torch.Tensor)
                  else nbytes(corp.codes, corp.scale))
        eng = DenseEngine(world["cfg"], world["sd"], world["tok"], corp,
                          docids, ServeConfig(topk=k, batch_sizes=tuple(
                              sz["dense_batches"])), device=dev)
        recs = []
        for b in sz["dense_batches"]:
            qs = queries[:b]
            ids, mask = tokenize_queries(world["tok"], qs, 64)
            with torch.inference_mode():
                reps = eng._model.dense_rep(
                    torch.as_tensor(ids, device=dev),
                    torch.as_tensor(mask, device=dev)).float().cpu().numpy()
            eng_t, scan_t = [], []
            for _ in range(sz["dense_reps"]):
                t0 = time.monotonic()
                res = eng.retrieve_batch(qs)
                eng_t.append(time.monotonic() - t0)
                t0 = time.monotonic()
                dense_topk(reps, corp, k)
                scan_t.append(time.monotonic() - t0)
            check_dense(tag, res, k)
            eng_ms, scan_ms = (float(np.median(t)) * 1e3
                               for t in (eng_t, scan_t))
            recs.append({"batch": b, "engine_ms": eng_ms,
                         "engine_qps": b / eng_ms * 1e3,
                         "engine_ms_runs": [t * 1e3 for t in eng_t],
                         "scan_ms": scan_ms, "scan_qps": b / scan_ms * 1e3,
                         "scan_ms_runs": [t * 1e3 for t in scan_t]})
            if b == max(sz["dense_batches"]):
                if tag == "bf16":
                    eng_reps = reps
                if dev == "cuda":
                    where_time_goes(f"dense {tag} B={b}",
                                    lambda: eng.retrieve_batch(qs),
                                    eng_ms / 1e3,
                                    shape={"batch": b, "docs": n,
                                           "topk": k})
        print("dense_serving", json.dumps({
            "corpus": tag, "docs": n, "dim": d, "topk": k,
            "corpus_gb": cbytes / 1e9,
            "bound_ms": cbytes / HBM_BYTES_PER_S * 1e3,
            "batches": recs}))
        del eng
    # the 1M-row slice against a plain f32 reference
    m = min(sz["check_rows"], n)
    q = torch.as_tensor(eng_reps, device=dev).to(torch.bfloat16)
    with exact_f32():
        ref = q.float() @ corpus[:m].float().T
    rs, ri = (t.cpu().numpy() for t in torch.topk(ref, k, dim=1))
    del ref
    s16, i16 = dense_topk(eng_reps, corpus[:m], k)
    ok, worst = topk_sets_agree(s16, i16, rs, ri)
    check(ok, f"dense bf16 vs f32 reference: sets or scores apart ({worst})")
    s8, i8 = dense_topk(eng_reps, Int8Corpus(c8.codes[:m], c8.scale[:m]), k)
    top1 = float(np.mean(i8[:, 0] == ri[:, 0]))
    overlap = float(np.mean([len(set(a[:10]) & set(b[:10])) / 10.0
                             for a, b in zip(i8, ri)]))
    # where the int8 pick is not the reference's best, the best may lead
    # it by no more than the two docs' int8 error bounds: rint moves each
    # element by at most scale / 2, a score by at most sum|q| * scale / 2
    qabs = q.float().abs().sum(dim=1).cpu().numpy()
    scale = c8.scale[:m].cpu().numpy()
    lead = []
    for b in np.flatnonzero(i8[:, 0] != ri[:, 0]):
        a, r = int(i8[b, 0]), int(ri[b, 0])
        with exact_f32():
            true_a = float(q[b].float() @ corpus[a].float())
        lead.append(float((rs[b, 0] - true_a) / (
            qabs[b] * (scale[a] + scale[r]) / 2 * (1 + 1e-5))))
    print("dense_check", json.dumps({
        "rows": m, "queries": len(eng_reps), "bf16_max_rel_score_diff": worst,
        "int8_top1_equal": top1, "int8_top10_overlap": overlap,
        "int8_top1_lead_over_error_bound": lead,
        "make_corpus_s": make_s, "peak_gb": peak_gb(dev)}))
    check(all(x <= 1.0 for x in lead),
          f"dense int8: a top-1 pick beyond its error bound ({lead})")
    check(overlap >= 0.9, f"dense int8: top-10 overlap {overlap}")
    del corpus, c8
    reset_peak(dev)


def check_dense(tag, res, k):
    for r in res:
        s = [v for _, v in r]
        check(len(r) == k, f"dense {tag}: {len(r)} results, not {k}")
        check(all(np.isfinite(s)), f"dense {tag}: non-finite score")
        check(all(a >= b for a, b in zip(s, s[1:])),
              f"dense {tag}: scores increase")


def docid_cli_phase(world, launches, tmp, sz):
    """Phase 9 (c): the DocID build and dense retrieval through the CLI,
    on a new workspace beside phase 7's: its params.pt (phase 4's model),
    its WordTokenizer and its 16 queries, and a 100,000-doc corpus of
    phase 7's words (8-20 words a doc, encoded at 32 positions: a cut of
    the 128 default; a fifth of them repeat another doc's text, so RQ
    groups hold several docs). ``index --nranks 2`` (both ranks) + ``merge-embs``,
    ``aq-index --M 32 --K 256``; ``dense-retrieve`` on host blocks, with
    ``--device-corpus`` (equal apart from ties: the reps are bf16-exact)
    and ``--corpus-quant int8`` (scores within tests/test_eval.py's bar of
    the exact ones); ``evaluate`` on a constructed qrel; ``hnsw-index``
    (16 links, ef_construct 64: a cut of build time) + ``--ann hnsw``
    (ef_search 256; recall@100 against flat); ``serve_http`` over a
    DenseEngine (POST /retrieve equal to retrieve_batch). Last,
    install_codebooks of the aq-index codebooks into the model and
    ``retrieve`` at beam = topk = 1000 over the RQ-built
    docid_to_smtid.json (groups hold several docs), with phase 4's checks,
    then dev_eval's unconstrained search over the same model: K1-K3 must
    launch in each (counters zeroed just before, read just after)."""
    import http.client
    import os
    import shutil

    import torch
    from ripor_tpu_torch.cli.main import _bf16_model
    from ripor_tpu_torch.data.datasets import (Collection,
                                               load_docid_to_smtid)
    from ripor_tpu_torch.data.emb_store import open_mmap
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.evaluation.dev_eval import dev_eval
    from ripor_tpu_torch.evaluation.retriever import device_corpus
    from ripor_tpu_torch.models import install_codebooks
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.pipeline import load_tokenizer
    from ripor_tpu_torch.serve import DenseEngine, ServeConfig, serve_http
    from ripor_tpu_torch.train import load_params, save_params
    from ripor_tpu_torch.trie import DocIdTrie

    dev = sz["device"]
    src = os.path.join(tmp, "ws")
    ws = os.path.join(tmp, "ws9")
    os.makedirs(os.path.join(ws, "checkpoints"))
    shutil.copytree(os.path.join(src, "checkpoints", "final"),
                    os.path.join(ws, "checkpoints", "final"))
    shutil.copy(os.path.join(src, "tokenizer.json"), ws)
    qdir = os.path.join(tmp, "queries")
    qids = Collection(qdir).ids
    rng = np.random.default_rng(SEED + 9)
    docs = os.path.join(tmp, "docs9")
    os.makedirs(docs)
    # a fifth of the docs repeat another doc's text (as MS MARCO holds
    # duplicate passages): equal reps, equal smtids, groups of several docs
    texts = [" ".join(rng.choice(world["words"], rng.integers(8, 21)))
             for _ in range(sz["cli_docs"] * 4 // 5)]
    texts += [texts[j] for j in rng.integers(0, len(texts),
                                             sz["cli_docs"] - len(texts))]
    with open(os.path.join(docs, "raw.tsv"), "w") as f:
        f.writelines(f"p{i}\t{t}\n" for i, t in enumerate(texts))
    mmap, aq = os.path.join(tmp, "mmap9"), os.path.join(tmp, "aq9")
    devf = ["--device", dev]
    steps = {}

    def timed(tag, argv):
        t0 = time.monotonic()
        out = run_cli(argv, tag)
        steps[tag] = time.monotonic() - t0
        return out

    for rank in (0, 1):
        timed(f"index rank {rank}",
              ["index", "--workspace", ws, "--docs", docs, "--rank",
               str(rank), "--nranks", "2", "--max-length",
               str(sz["cli_doc_len"]), *devf])
    timed("merge-embs", ["merge-embs", "--emb-dir",
                         os.path.join(ws, "embs"), "--mmap-dir", mmap])
    timed("aq-index", ["aq-index", "--mmap-dir", mmap, "--out-dir", aq,
                       "--M", str(sz["cli_M"]), "--K", str(sz["cli_K"]),
                       *devf])
    check(sorted(os.listdir(aq)) == ["codebooks.npz.npy",
                                     "docid_to_smtid.json"],
          f"aq-index wrote {sorted(os.listdir(aq))}")
    embs, docids = open_mmap(mmap)
    check(embs.shape == (sz["cli_docs"], world["cfg"].t5.d_model),
          f"merge-embs: {embs.shape}")

    base = ["dense-retrieve", "--workspace", ws, "--queries", qdir,
            "--topk", str(sz["cli_topk"]), *devf]
    runs = {}
    for tag, extra in (("host", ["--mmap-dir", mmap]),
                       ("device", ["--mmap-dir", mmap, "--device-corpus"]),
                       ("int8", ["--mmap-dir", mmap, "--device-corpus",
                                 "--corpus-quant", "int8"])):
        out = os.path.join(ws, f"run_dense_{tag}.json")
        timed(f"dense-retrieve {tag}", base + extra + ["--out", out])
        runs[tag] = read_run(out)
    tok = load_tokenizer(os.path.join(ws, "tokenizer.json"))
    params = load_params(os.path.join(ws, "checkpoints", "final"))
    model = _bf16_model(world["cfg"], params, dev)
    ids, mask = tokenize_queries(tok, Collection(qdir).texts, 64)
    with torch.inference_mode():
        q = model.dense_rep(torch.as_tensor(ids, device=dev),
                            torch.as_tensor(mask, device=dev)).float()
        exact = (q.double() @ torch.tensor(np.asarray(embs), device=dev)
                 .double().T).cpu().numpy()
    col = {d: i for i, d in enumerate(docids)}
    worst8 = 0.0
    for qi, qid in enumerate(qids):
        top = np.argsort(-exact[qi], kind="stable")[:sz["cli_topk"]]
        for tag in ("host", "device"):
            got = runs[tag][qid]
            s_got = np.array([v for _, v in got])
            ok, worst = topk_sets_agree(
                s_got[None], np.array([col[d] for d, _ in got])[None],
                exact[qi, top][None], top[None])
            check(ok, f"dense-retrieve {tag}: {qid} apart from the exact "
                  f"top-{sz['cli_topk']} ({worst})")
        for d_, v in runs["int8"][qid]:
            e = exact[qi, col[d_]]
            worst8 = max(worst8, abs(v - e) / (0.05 + 0.05 * abs(e)))
    check(worst8 <= 1.0, f"dense-retrieve int8: scores beyond rtol 0.05 / "
          f"atol 0.05 of the exact ones ({worst8})")

    qrel, ranks = mrr_qrel([runs["host"][q] for q in qids], qids)
    qrel_path = os.path.join(tmp, "qrel9.json")
    with open(qrel_path, "w") as f:
        json.dump(qrel, f)
    got = json.loads(run_cli(["evaluate", "--qrel", qrel_path, "--run",
                              os.path.join(ws, "run_dense_host.json"),
                              "--metric", "mrr_10"], "evaluate dense"))
    expect = sum(1.0 / r for r in ranks) / len(ranks)
    check(got == {"mrr_10": expect}, f"evaluate dense: {got} vs {expect}")

    hnsw = os.path.join(tmp, "hnsw9")
    # a lighter graph than the defaults (32 links, ef_construct 128, whose
    # build took 106 s of the card machine's 8 cores): a cut of build time
    hout = timed("hnsw-index", ["hnsw-index", "--mmap-dir", mmap,
                                "--index-dir", hnsw, "--num-links", "16",
                                "--ef-construct", "64"])
    out = os.path.join(ws, "run_dense_hnsw.json")
    timed("dense-retrieve hnsw", base + ["--ann", "hnsw", "--index-dir",
                                         hnsw, "--ef-search", "256",
                                         "--out", out])
    hrun = read_run(out)
    recall = float(np.mean([
        len({d for d, _ in hrun[q]} & {d for d, _ in runs["host"][q]})
        / sz["cli_topk"] for q in qids]))
    check(recall >= 0.5, f"hnsw recall@{sz['cli_topk']} vs flat {recall}")

    # serve --mode dense: the engine cmd_serve builds, over HTTP
    eng = DenseEngine(world["cfg"], params, tok,
                      device_corpus(np.asarray(embs), device=dev), docids,
                      ServeConfig(topk=sz["cli_topk"], batch_sizes=(8,)),
                      device=dev)
    texts = Collection(qdir).texts[:8]
    want = eng.retrieve_batch(texts)
    server = serve_http(eng, port=0, block=False)
    host, port = server.server_address
    try:
        conn = http.client.HTTPConnection(host, port, timeout=600)
        conn.request("POST", "/retrieve", body=json.dumps({"queries": texts}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        check(resp.status == 200, f"dense POST /retrieve: {resp.status}")
        got = [[tuple(x) for x in r] for r in body["results"]]
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()
    check_same_run("dense HTTP vs retrieve_batch",
                   dict(zip(qids, got)), dict(zip(qids, want)))
    del eng
    print("docid_cli", json.dumps({
        "docs": sz["cli_docs"], "doc_positions": sz["cli_doc_len"],
        "queries": len(qids), "seconds": steps,
        "int8_worst_over_bar": worst8,
        "hnsw_recall_vs_flat": recall, "hnsw_native": "native=True" in hout,
        "evaluate_mrr_10": expect}))

    # the RQ DocIDs into the model, and retrieval over their trie
    books = np.load(os.path.join(aq, "codebooks.npz.npy"))
    rq_ckpt = os.path.join(ws, "checkpoints", "rq")
    save_params(rq_ckpt, install_codebooks(params, books), world["cfg"])
    shutil.copy(os.path.join(aq, "docid_to_smtid.json"), ws)
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    out = timed("retrieve rq", [
        "retrieve", "--workspace", ws, "--queries", qdir, "--phase", "rq",
        "--beam", str(sz["cli_beam"]), "--topk", str(sz["cli_beam"]),
        "--run-name", "run_rq.json", *devf])
    counts = dict(KERNEL_LAUNCHES)
    trie = DocIdTrie.load(os.path.join(ws, "trie.npz"))
    check(trie.num_groups < sz["cli_docs"],
          f"RQ trie: {trie.num_groups} groups for {sz['cli_docs']} docs")
    run = read_run(os.path.join(ws, "run_rq.json"))
    check(list(run) == qids, "retrieve rq: qids")
    if dev == "cuda":
        check_results("retrieve rq", list(run.values()))
        for k in MEGAROW_KERNELS:
            check(counts[k] > 0, f"retrieve rq: kernel {k} never launched")
    _, rq_codes = load_docid_to_smtid(os.path.join(ws,
                                                   "docid_to_smtid.json"))
    model = install_codebooks(model, books)
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0
    ids, mask = tokenize_queries(tok, Collection(qdir).texts[:B], 64)
    t0 = time.monotonic()
    dev_metrics = dev_eval(world["cfg"], model, [(ids, mask)],
                           rq_codes[:B], num_beams=sz["dev_eval_beams"])
    dev_s = time.monotonic() - t0
    dcounts = dict(KERNEL_LAUNCHES)
    if dev == "cuda":
        for k in MEGAROW_KERNELS:
            check(dcounts[k] > 0, f"dev_eval: kernel {k} never launched")
            launches[k] = counts[k] + dcounts[k]
    print("docid_retrieve", json.dumps({
        "beam": sz["cli_beam"], "topk": sz["cli_beam"], "docs": sz["cli_docs"],
        "trie_groups": int(trie.num_groups),
        "trie_nodes": int(trie.num_internal),
        "max_docs_in_a_group": int(np.max(np.diff(trie.group_doc_offsets))),
        "retrieve_timing": timing_line(out),
        "launches": {k: counts[k] for k in MEGAROW_KERNELS},
        "dev_eval": {"queries": B, "beams": sz["dev_eval_beams"],
                     "seconds": dev_s, **dev_metrics,
                     "launches": {k: dcounts[k] for k in MEGAROW_KERNELS}}}))
    del model, params
    reset_peak(dev)


def e2e_phase(tmp, sz):
    """Phase 9 (d): ``run_e2e`` at tests/test_pipeline.py::test_e2e_slice's
    geometry (40 docs, 12 queries, M=4, K=16, 60 epochs) on the card, a
    WordTokenizer written first (the card's machine has no tokenizers
    package): mrr_10 and recall_10 above 0.5, the JAX test's bar."""
    import os
    from ripor_tpu_torch.data.tokenizer import WordTokenizer
    from ripor_tpu_torch.pipeline.e2e import run_e2e

    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliet", "kilo", "lima", "mike",
             "november"]
    rng = np.random.default_rng(0)
    root = os.path.join(tmp, "e2e")
    docs_dir, queries_dir = (os.path.join(root, n) for n in ("docs",
                                                             "queries"))
    os.makedirs(docs_dir)
    os.makedirs(queries_dir)
    texts = [" ".join(rng.choice(words, 6)) + f" topic{i}" for i in range(40)]
    with open(os.path.join(docs_dir, "raw.tsv"), "w") as f:
        f.writelines(f"d{i}\t{t}\n" for i, t in enumerate(texts))
    qrel = {}
    with open(os.path.join(queries_dir, "raw.tsv"), "w") as f:
        for qi in range(12):
            di = qi * 3
            f.write(f"q{qi}\tfind topic{di} {texts[di].split()[0]}\n")
            qrel[f"q{qi}"] = {f"d{di}": 1}
    with open(os.path.join(root, "qrel.json"), "w") as f:
        json.dump(qrel, f)
    ws = os.path.join(root, "ws")
    os.makedirs(ws)
    WordTokenizer.train(texts + ["find"], vocab_size=300).save(
        os.path.join(ws, "tokenizer.json"))
    t0 = time.monotonic()
    metrics = run_e2e(workspace=ws, docs_dir=docs_dir,
                      queries_dir=queries_dir,
                      qrel_path=os.path.join(root, "qrel.json"), M=4, K=16,
                      vocab_size=300, s2s_epochs=60, learning_rate=2e-3,
                      batch_size=12, num_beams=5, topk=20,
                      device=sz["device"])
    print("e2e", json.dumps({"seconds": time.monotonic() - t0, **metrics}))
    check(metrics["mrr_10"] > 0.5 and metrics["recall_10"] > 0.5,
          f"e2e: {metrics}, the JAX test's bar is 0.5")


def docid_phase(world, launches, tmp, sz=P9):
    """Phase 9: (a) docid_build, (b) dense_serving, (c) docid_cli_phase,
    (d) e2e_phase. Adds (c)'s launches of K1-K3 to ``launches``."""
    t0 = time.monotonic()
    docid_build(sz)
    dense_serving(world, sz)
    docid_cli_phase(world, launches, tmp, sz)
    e2e_phase(tmp, sz)
    print("phase9_s", time.monotonic() - t0)


# ---- phase 10: the teacher and the baselines ----

# The full-width run of phase 10. A rehearsal at a tiny size on the CPU
# passes a smaller copy (every function below reads its sizes from here).
P10 = dict(
    device="cuda",
    # BertCrossEncoder at MiniLM-L6 geometry (the reference teacher,
    # cross-encoder/ms-marco-MiniLM-L-6-v2) and BertDenseEncoder at
    # bert-base; the T5 families at t5-base ({} = T5Config's defaults)
    minilm=dict(vocab_size=30522, d_model=384, num_layers=6, num_heads=12,
                d_ff=1536, max_position=512),
    bert_base=dict(vocab_size=30522, d_model=768, num_layers=12,
                   num_heads=12, d_ff=3072, max_position=512),
    t5={}, M=M, K=K,
    fwd_pairs=64, fwd_len=256, base_seqs=16, base_len=128, t5_seqs=16,
    t5_len=64, fwd_reps=10,
    score_queries=64, score_topk=100, score_len=256,
    score_batches=(64, 512), score_reps=10, doc_words=(50, 200),
    parity_b=4, bert_b=32, t5_b=16, train_steps=8, t5_steps=2,
    cli_topk=100, cli_neg=8, cli_b=32, cli_len=256, cli_self_docs=20,
)


def bert_pair_flops(geo, length):
    """Forward operations of one sequence of ``length`` positions through a
    BERT of geometry ``geo``: per layer and position the Q/K/V/O
    projections (4 d^2) and the FFN (2 d d_ff), and the q.k and p.v
    products (2 length d); 2 operations a multiply-add. At MiniLM-L6 and
    length 256: 21.2 + 2.4 MFLOP a position, 6.04 GFLOP a pair."""
    d, f = geo["d_model"], geo["d_ff"]
    return geo["num_layers"] * length * 2 * (4 * d * d + 2 * d * f
                                             + 2 * length * d)


def device_ms(fn, dev, reps):
    """Mean time of fn() over reps calls after a warm-up: CUDA events on
    the card, the host clock on the CPU (a rehearsal)."""
    import torch
    if torch.device(dev).type == "cuda":
        return cuda_ms(fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def t5_config(sz, dropout):
    import dataclasses

    from ripor_tpu_torch.models import T5Config
    return dataclasses.replace(T5Config(**sz["t5"]), dropout_rate=dropout)


def ripor_config(sz, dropout):
    from ripor_tpu_torch.models import RiporConfig
    return RiporConfig(t5=t5_config(sz, dropout), M=sz["M"], K=sz["K"])


def family(name, sz, dropout=0.0):
    """A function device -> a float32 model of the family ``name``."""
    from ripor_tpu_torch.models import (BertCrossEncoder, BertDenseEncoder,
                                        T5DenseEncoder, T5SeqCrossEncoder)
    if name == "BertCrossEncoder":
        return lambda dev: BertCrossEncoder(**sz["minilm"], dropout=dropout,
                                            device=dev)
    if name == "BertDenseEncoder":
        return lambda dev: BertDenseEncoder(**sz["bert_base"],
                                            dropout=dropout, device=dev)
    if name == "T5SeqCrossEncoder":
        return lambda dev: T5SeqCrossEncoder(ripor_config(sz, dropout),
                                             device=dev)
    return lambda dev: T5DenseEncoder(t5_config(sz, dropout), device=dev)


def bert_pairs(rng, vocab, b, length):
    """Pair encodings as BertBceCollator writes them: [CLS] q [SEP] d [EOS]
    rows of 60-100 % of ``length`` real tokens, token types 1 after the
    [SEP], alternating labels."""
    from ripor_tpu_torch.data.tokenizer import CLS_ID, EOS_ID, SEP_ID
    ids = rng.integers(5, vocab, (b, length)).astype(np.int32)
    mask = np.zeros((b, length), np.int32)
    types = np.zeros((b, length), np.int32)
    for i in range(b):
        n = int(rng.integers(int(0.6 * length), length + 1))
        sep = int(rng.integers(3, length // 3))
        ids[i, [0, sep, n - 1]] = (CLS_ID, SEP_ID, EOS_ID)
        ids[i, n:] = 0
        mask[i, :n] = 1
        types[i, sep + 1:n] = 1
    return {"input_ids": ids, "attention_mask": mask, "token_type_ids": types,
            "labels": (np.arange(b) % 2).astype(np.float32)}


def token_rows(rng, vocab, b, length):
    """[b, length] ids with 60-100 % real tokens, and their mask."""
    ids = rng.integers(5, vocab, (b, length)).astype(np.int32)
    mask = np.zeros((b, length), np.int32)
    for i in range(b):
        mask[i, :int(rng.integers(int(0.6 * length), length + 1))] = 1
    return ids * mask, mask


def loss_batch(loss, rng, sz, b):
    """A batch of ``loss``'s collator's keys and shapes."""
    if loss == "bert_bce":
        return bert_pairs(rng, sz["minilm"]["vocab_size"], b, sz["fwd_len"])
    v = t5_config(sz, 0.0).vocab_size
    if loss == "t5seq_bce":
        ids, mask = token_rows(rng, v, b, sz["t5_len"])
        return {"query_ids": ids, "query_mask": mask,
                "codes": rng.integers(0, sz["K"], (b, sz["M"])
                                      ).astype(np.int32),
                "labels": (np.arange(b) % 2).astype(np.float32)}
    batch = {}
    for side in ("query", "pos_doc", "neg_doc"):
        batch[f"{side}_ids"], batch[f"{side}_mask"] = token_rows(
            rng, v, b, sz["t5_len"])
    for side in ("pos", "neg"):
        batch[f"teacher_{side}_score"] = (rng.standard_normal(b) * 5
                                          ).astype(np.float32)
    return batch


TEACHER_LOSSES = (("bert_bce", "BertCrossEncoder"),
                  ("t5seq_bce", "T5SeqCrossEncoder"),
                  ("margin_mse", "T5DenseEncoder"),
                  ("kldiv", "T5DenseEncoder"))


def teacher_forwards(sz):
    """Phase 10 (a): each family's forward on the card against the CPU
    from the same seeded float32 params (TF32 off): BertCrossEncoder at
    MiniLM-L6 on 64 pairs of 256 positions, BertDenseEncoder at bert-base
    on 16 x 128, T5DenseEncoder at t5-base and T5SeqCrossEncoder at
    ripor_base(M=32, K=256) on 16 x 64. Bar: |card - CPU| <= 1e-4 *
    max(1, |CPU|) entry by entry."""
    import torch
    from ripor_tpu_torch.models import init_params
    dev = sz["device"]
    rng = np.random.default_rng(SEED + 10)
    v = t5_config(sz, 0.0).vocab_size
    pairs = bert_pairs(rng, sz["minilm"]["vocab_size"], sz["fwd_pairs"],
                       sz["fwd_len"])
    base = token_rows(rng, sz["bert_base"]["vocab_size"], sz["base_seqs"],
                      sz["base_len"])
    t5 = token_rows(rng, v, sz["t5_seqs"], sz["t5_len"])
    codes = rng.integers(0, sz["K"], (sz["t5_seqs"], sz["M"])).astype(
        np.int32)
    cases = (("BertCrossEncoder", (pairs["input_ids"],
                                   pairs["attention_mask"],
                                   pairs["token_type_ids"]),
              bert_pair_flops(sz["minilm"], sz["fwd_len"])
              * sz["fwd_pairs"]),
             ("BertDenseEncoder", base,
              bert_pair_flops(sz["bert_base"], sz["base_len"])
              * sz["base_seqs"]),
             ("T5DenseEncoder", t5, None),
             ("T5SeqCrossEncoder", t5 + (codes,), None))
    for name, args, flops in cases:
        make = family(name, sz)
        cpu = make("cpu")
        t0 = time.monotonic()
        sd = init_params(cpu, torch.Generator().manual_seed(SEED))
        init_s = time.monotonic() - t0
        cpu.load_state_dict(sd)
        card = make(dev)
        card.load_state_dict(sd)
        del sd
        on_card = [torch.as_tensor(a).to(dev) for a in args]
        with torch.no_grad():
            t0 = time.monotonic()
            want = cpu(*map(torch.as_tensor, args))
            cpu_s = time.monotonic() - t0
            got = card(*on_card).cpu()
            ms = device_ms(lambda: card(*on_card), dev, sz["fwd_reps"])
        err = (got - want).abs()
        ratio = float((err / want.abs().clamp(min=1.0)).max())
        rec = {"model": name, "input": list(args[0].shape),
               "output": list(got.shape), "max_abs_diff": float(err.max()),
               "max_diff_over_bar": ratio / 1e-4, "card_ms": ms,
               "cpu_s": cpu_s, "init_s": init_s,
               "params": sum(p.numel() for p in card.parameters())}
        if flops is not None:
            rec.update(flops=flops, bound_ms_f32=flops / F32_FLOPS * 1e3)
        print("teacher_forward", json.dumps(rec))
        check(bool(torch.isfinite(got).all()), f"10a {name}: not finite")
        check(ratio <= 1e-4, f"10a {name}: card and CPU differ: {rec}")
        del cpu, card, on_card
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()


def teacher_scoring(sz, tmp):
    """Phase 10 (b): load_bert_teacher from a params.pt +
    bert_geometry.json checkpoint (MiniLM-L6, seeded random weights), then
    rerank_pairs over 64 queries x 100 candidates at max_length 256, in
    batches of 64 (the rerank CLI's default) and 512: pairs/s, the
    device's ms per batch beside its float32 FLOP bound, the host's share
    (encode_pairs tokenizing in Python), and the busy share of one
    profiled batch."""
    import os

    import torch
    from ripor_tpu_torch.data.tokenizer import SEP_ID, HashTokenizer
    from ripor_tpu_torch.evaluation.reranker import (encode_pairs,
                                                     load_bert_teacher,
                                                     rerank_pairs)
    from ripor_tpu_torch.models import init_params
    from ripor_tpu_torch.train import save_params

    dev, geo, length = sz["device"], sz["minilm"], sz["score_len"]
    make = family("BertCrossEncoder", sz, dropout=0.1)
    ckpt = os.path.join(tmp, "teacher10")
    save_params(ckpt, init_params(make("meta"),
                                  torch.Generator().manual_seed(SEED + 10)))
    with open(os.path.join(ckpt, "bert_geometry.json"), "w") as f:
        json.dump({k: v for k, v in geo.items() if k != "vocab_size"}, f)
    t0 = time.monotonic()
    score_fn = load_bert_teacher(ckpt, geo["vocab_size"], device=dev)
    load_s = time.monotonic() - t0
    tok = HashTokenizer(geo["vocab_size"])
    rng = np.random.default_rng(SEED + 11)
    words = [f"t{i}" for i in range(20000)]
    lo, hi = sz["doc_words"]
    docs = {f"d{j}": " ".join(rng.choice(words, rng.integers(lo, hi + 1)))
            for j in range(4 * sz["score_topk"])}
    queries = {f"q{i}": " ".join(rng.choice(words, rng.integers(3, 12)))
               for i in range(sz["score_queries"])}
    docids = list(docs)
    pairs = [(q, d) for q in queries
             for d in rng.choice(docids, sz["score_topk"], replace=False)]
    flops = bert_pair_flops(geo, length)
    ce = make(dev)
    ce.load_state_dict(torch.load(os.path.join(ckpt, "params.pt"),
                                  weights_only=True))
    for bs in sz["score_batches"]:
        rerank_pairs(score_fn, tok, queries, docs, pairs[:bs], bs, length)
        sync(dev)
        t0 = time.monotonic()
        scored = rerank_pairs(score_fn, tok, queries, docs, pairs, bs, length)
        sync(dev)
        wall_s = time.monotonic() - t0
        t0 = time.monotonic()
        for s in range(0, len(pairs), bs):
            chunk = pairs[s:s + bs]
            ids, mask = encode_pairs(
                tok, [queries[q] for q, _ in chunk] + [""] * (bs - len(chunk)),
                [docs[d] for _, d in chunk] + [""] * (bs - len(chunk)),
                length)
        encode_s = time.monotonic() - t0
        ids, mask = encode_pairs(tok, [queries[q] for q, _ in pairs[:bs]],
                                 [docs[d] for _, d in pairs[:bs]], length)
        ids_d, mask_d = (torch.as_tensor(a).to(dev) for a in (ids, mask))
        # the token types load_bert_teacher derives from the first [SEP]
        types = (mask_d * (torch.arange(length, device=dev)[None] > (
            ids_d == SEP_ID).int().argmax(1)[:, None])).int()
        with torch.no_grad():
            ms = device_ms(lambda: ce(ids_d, mask_d, types), dev,
                           sz["score_reps"])
        n_batches = -(-len(pairs) // bs)
        bound_ms = bs * flops / F32_FLOPS * 1e3
        n = sum(len(v) for v in scored.values())
        check(n == len(set(pairs)) and all(
            np.isfinite(v) for d in scored.values() for v in d.values()),
            f"10b: {n} scores for {len(set(pairs))} pairs")
        print("teacher_scoring", json.dumps({
            "batch": bs, "max_length": length, "pairs": len(pairs),
            "queries": len(queries), "topk": sz["score_topk"],
            "pairs_per_s": len(pairs) / wall_s, "wall_s": wall_s,
            "pairs_per_s_bound_f32": F32_FLOPS / flops,
            "gflop_per_pair": flops / 1e9, "device_ms_per_batch": ms,
            "bound_ms_per_batch_f32": bound_ms,
            "roofline_share_f32": bound_ms / ms,
            "device_s_all_batches": ms * n_batches / 1e3,
            "encode_pairs_s": encode_s, "host_share_encode": encode_s / wall_s,
            "real_tokens_share": float(mask.mean()), "load_s": load_s}))
    if torch.device(dev).type == "cuda":
        bs = sz["score_batches"][0]

        def one_batch():
            return rerank_pairs(score_fn, tok, queries, docs, pairs[:bs], bs,
                                length)
        one_batch()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        one_batch()
        torch.cuda.synchronize()
        where_time_goes(f"teacher rerank_pairs B={bs}", one_batch,
                        time.monotonic() - t0,
                        {"batch": bs, "max_length": length})
    del ce, score_fn


def teacher_training(sz):
    """Phase 10 (c): one step of each teacher and baseline loss on the card
    and on the CPU from the same params, dropout off (bert_bce at
    MiniLM-L6 and 256 positions, t5seq_bce at ripor_base, margin_mse and
    kldiv at t5-base's T5DenseEncoder with 64 positions; B=4 on both
    sides, the CPU being the slow one): losses, grad_norm and updated
    params at phase 8's bars (param_agreement). Then Trainer.run of each
    loss on the card with dropout 0.1 at its full batch: bert_bce at B=32
    (2 warm-up and 8 timed steps: ms a step, examples/s, MFU against the
    float32 peak), t5seq_bce, margin_mse and kldiv at B=16 (2 + 2)."""
    import torch
    from ripor_tpu_torch.models import init_params
    from ripor_tpu_torch.train import TrainConfig, Trainer

    dev = sz["device"]
    rng = np.random.default_rng(SEED + 12)
    for loss, name in TEACHER_LOSSES:
        make = family(name, sz)
        sd = init_params(make("meta"), torch.Generator().manual_seed(SEED))
        batch = loss_batch(loss, rng, sz, sz["parity_b"])
        tcfg = TrainConfig(loss_type=loss)
        out = {}
        for where in ("cpu", dev):
            model = make(where)
            t0 = time.monotonic()
            _, metrics = Trainer(model, tcfg, sd).run([batch])
            metrics = {k: float(v) for k, v in metrics.items()}
            out[where] = (metrics, {k: v.detach().cpu() for k, v in
                                    model.state_dict().items()},
                          time.monotonic() - t0)
            if where == "cpu":
                scale = min(1.0, tcfg.grad_clip / metrics["grad_norm"])
                steady = {k: (p.grad.abs() * scale >= 1e-6
                              if p.grad is not None
                              else torch.zeros_like(p, dtype=torch.bool))
                          for k, p in model.named_parameters()}
            del model
        (mc, pc, cpu_s), (mg, pg, dev_s) = out["cpu"], out[dev]
        rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30) for k in mc}
        agree = param_agreement(pg, pc, steady=steady)
        moved = param_agreement(pc, sd)
        print("teacher_train_parity", json.dumps({
            "loss": loss, "model": name, "batch": sz["parity_b"],
            "cpu": mc, "card": mg, "rel_diff": rel, "params": agree,
            "params_moved_share": 1.0 - moved["equal_share"],
            "cpu_step_s": cpu_s, "card_step_s": dev_s}))
        check(set(mc) == set(mg) and all(np.isfinite(v) for v in mg.values()),
              f"10c {loss}: metrics {mg}")
        check(max(rel[k] for k in rel if k != "grad_norm") <= 1e-4
              and rel["grad_norm"] <= 1e-3, f"10c {loss}: {rel}")
        check(agree["max_abs"] <= 2 * tcfg.learning_rate + 1e-6
              and agree["loose_share"] <= 1e-2
              and agree["steady_loose_share"] <= 1e-6,
              f"10c {loss}: updated params differ: {agree}")
        del out, pc, pg, steady, sd
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

    # speed at the default dropout 0.1: bert_bce at B=32 x 256 (8 timed
    # steps; MFU from bert_pair_flops), the T5 families at B=16 (2 timed)
    for loss, name in TEACHER_LOSSES:
        bert = loss == "bert_bce"
        make = family(name, sz, dropout=0.1)
        sd = init_params(make("meta"), torch.Generator().manual_seed(SEED))
        b = sz["bert_b"] if bert else sz["t5_b"]
        steps = sz["train_steps"] if bert else sz["t5_steps"]
        batches = [loss_batch(loss, rng, sz, b) for _ in range(steps + 2)]
        flops = (3 * b * bert_pair_flops(sz["minilm"], sz["fwd_len"])
                 if bert else None)
        logs = []
        trainer = Trainer(make(dev), TrainConfig(loss_type=loss), sd,
                          log_fn=lambda m, s: logs.append((s, m)))
        del sd
        reset_peak(dev)
        t0 = time.monotonic()
        trainer.run(batches, seed=SEED, log_every=1, flops_per_step=flops)
        wall_s = time.monotonic() - t0
        last = logs[-1][1]
        check([s for s, _ in logs] == list(range(1, len(batches) + 1))
              and all(np.isfinite(m["loss"]) for _, m in logs),
              f"10c {loss} speed: {[(s, m['loss']) for s, m in logs]}")
        p50 = last["p50_s"]
        rec = {"loss": loss, "model": name, "dropout": 0.1, "batch": b,
               "positions": sz["fwd_len"] if bert else sz["t5_len"],
               "steps_warmup": 2, "steps_timed": last["steps"],
               "ms_per_step_median": p50 * 1e3,
               "ms_per_step_mean": last["mean_s"] * 1e3,
               "ms_per_step_p95": last["p95_s"] * 1e3,
               "examples_per_s": b / p50, "peak_memory_gb": peak_gb(dev),
               "wall_s": wall_s, "loss_first": logs[0][1]["loss"],
               "loss_last": last["loss"]}
        if bert:
            rec.update(flops_per_step=flops,
                       bound_ms_f32=flops / F32_FLOPS * 1e3,
                       mfu_f32=flops / p50 / F32_FLOPS)
        print("teacher_train_speed", json.dumps(rec))
        del trainer
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()


def rerank_cli(argv, tag, cwd):
    """The port's CLI as a process of its own; echoes its output."""
    sub = subprocess.run([sys.executable, "-m", "ripor_tpu_torch.cli.main",
                          *argv], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    for line in sub.stdout.splitlines():
        print(f"cli {tag}:", line)
    check(sub.returncode == 0, f"{tag}: exit {sub.returncode}: "
          f"{sub.stderr[-2000:]}")
    return sub.stdout


def read_jsonl(path):
    with open(path) as f:
        return {r["qid"]: r for r in map(json.loads, f)}


def same_scores(tag, got, want, tol=1e-5):
    """Two {qid: {"docids", "scores"}} trainsets: the same queries, docids
    in the same order, scores within tol * max(1, |score|)."""
    check(sorted(got) == sorted(want), f"{tag}: qids differ")
    for q, w in want.items():
        g = got[q]
        check(g["docids"] == w["docids"], f"{tag}: {q} docids differ")
        err = max((abs(a - b) / max(1.0, abs(b))
                   for a, b in zip(g["scores"], w["scores"])), default=0.0)
        check(err <= tol, f"{tag}: {q} scores differ by {err}")


def teacher_cli(world, sz, tmp):
    """Phase 10 (d): the CLI on phase 7's workspace, as processes of their
    own: bce_examples from build_bce_examples over the top 100 of phase
    7's run.json and its qrel (doc texts written for those docs);
    ``train --config`` with bert_bce at the default geometry (MiniLM-L6,
    the tokenizer's vocabulary) -> checkpoints/teacher/params.pt;
    ``rerank`` of that checkpoint, equal to rerank_pairs in this process;
    ``rerank-task rerank_for_create_trainset`` on two ranks at once, then
    ``rerank-task-merge --nranks 2``, equal to a one-rank run; and
    ``rerank-task query_to_docid_rerank_for_qid_smtids`` on phase 7's RIPOR
    checkpoint + its merge with the qrel, equal to rerank_query_smtids in
    this process."""
    import os

    from ripor_tpu_torch.data.datasets import (Collection,
                                               build_bce_examples,
                                               load_docid_to_smtid,
                                               save_bce_examples,
                                               smtid_to_str)
    from ripor_tpu_torch.evaluation.reranker import (load_bert_teacher,
                                                     rerank_pairs,
                                                     rerank_query_smtids)
    from ripor_tpu_torch.pipeline import load_tokenizer
    from ripor_tpu_torch.train import load_params

    dev = sz["device"]
    repo = os.path.dirname(os.path.abspath(__file__))
    ws, qdir = os.path.join(tmp, "ws"), os.path.join(tmp, "queries")
    with open(os.path.join(ws, "run.json")) as f:
        run = {q: dict(list(d.items())[:sz["cli_topk"]])
               for q, d in json.load(f).items()}
    run_path = os.path.join(tmp, "run10.json")      # the top 100 a query
    with open(run_path, "w") as f:
        json.dump(run, f)
    with open(os.path.join(tmp, "qrel.json")) as f:
        qrel = json.load(f)
    tok = load_tokenizer(os.path.join(ws, "tokenizer.json"))
    rng = np.random.default_rng(SEED + 13)
    docs_dir = os.path.join(tmp, "docs10")
    os.makedirs(docs_dir)
    cands = sorted({d for dd in run.values() for d in dd}
                   | {d for rel in qrel.values() for d in rel})
    lo, hi = sz["doc_words"]
    with open(os.path.join(docs_dir, "raw.tsv"), "w") as f:
        for d in cands:
            text = " ".join(rng.choice(world["words"],
                                       rng.integers(lo, hi + 1)))
            f.write(f"{d}\t{text}\n")
    rows = build_bce_examples(qrel, run, neg_sample=sz["cli_neg"])
    bce = os.path.join(tmp, "bce10.tsv")
    save_bce_examples(bce, rows)
    conf = os.path.join(tmp, "teacher_config.json")
    with open(conf, "w") as f:
        json.dump({"workspace": ws, "queries_dir": qdir,
                   "docs_dir": docs_dir, "examples_path": bce,
                   "loss_type": "bert_bce", "batch_size": sz["cli_b"],
                   "max_length": sz["cli_len"], "phase_name": "teacher"}, f)
    devf = ["--device", dev]
    t0 = time.monotonic()
    rerank_cli(["train", "--config", conf] + devf, "train bert_bce", repo)
    train_s = time.monotonic() - t0
    ckpt = os.path.join(ws, "checkpoints", "teacher")
    check(os.path.exists(os.path.join(ckpt, "params.pt"))
          and not os.path.exists(os.path.join(ckpt, "config.json")),
          "10d: the teacher checkpoint is not a bare params.pt")
    check("pooler.weight" in load_params(ckpt), "10d: not a BertCrossEncoder")

    length = ["--max-length", str(sz["cli_len"])]
    common = ["--queries", qdir, "--docs", docs_dir, "--tokenizer",
              os.path.join(ws, "tokenizer.json"), "--ce-checkpoint", ckpt,
              *length]
    out = os.path.join(tmp, "teacher_trainset.jsonl")
    t0 = time.monotonic()
    rerank_cli(["rerank", "--run", run_path, *common,
                "--ce-vocab-size", str(tok.vocab_size), "--topk",
                str(sz["cli_topk"]), "--out", out] + devf, "rerank", repo)
    rerank_s = time.monotonic() - t0
    score_fn = load_bert_teacher(ckpt, tok.vocab_size, device=dev)
    queries, docs = Collection(qdir), Collection(docs_dir)
    pairs = [(q, d) for q, dd in run.items() for d in dd]
    want = {q: {"docids": [d for d, _ in sorted(s.items(),
                                                key=lambda kv: -kv[1])],
                "scores": sorted(s.values(), reverse=True)}
            for q, s in rerank_pairs(score_fn, tok, queries, docs, pairs,
                                     max_length=sz["cli_len"]).items()}
    got = read_jsonl(out)
    same_scores("10d rerank vs rerank_pairs", got, want)
    check(sum(len(r["docids"]) for r in got.values()) == len(pairs),
          "10d rerank: pairs missing")

    task = ["rerank-task", "--task", "rerank_for_create_trainset",
            "--tokenizer", os.path.join(ws, "tokenizer.json"), "--queries",
            qdir, "--docs", docs_dir, "--ce-checkpoint", ckpt, "--run",
            run_path, *length] + devf
    two, one = os.path.join(tmp, "rerank_two"), os.path.join(tmp, "rerank_one")
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, "-m",
                               "ripor_tpu_torch.cli.main", *task, "--out-dir",
                               two, "--rank", str(r), "--nranks", "2"],
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for r, p in enumerate(procs):
        o, e = p.communicate(timeout=600)
        print(f"cli rerank-task rank {r}:", o.strip())
        check(p.returncode == 0, f"10d rank {r}: exit {p.returncode}: "
              f"{e[-2000:]}")
    ranks_s = time.monotonic() - t0
    merge = ["rerank-task-merge", "--task", "rerank_for_create_trainset",
             "--topk", str(sz["cli_topk"])]
    rerank_cli(merge + ["--out-dir", two, "--nranks", "2"], "merge", repo)
    run_cli(task + ["--out-dir", one], "rerank-task one rank")
    run_cli(merge + ["--out-dir", one, "--nranks", "1"], "merge one rank")
    name = "qid_docids_teacher_scores.train.json"
    same_scores("10d two ranks vs one", read_jsonl(os.path.join(two, name)),
                read_jsonl(os.path.join(one, name)))
    same_scores("10d rerank-task vs rerank", read_jsonl(
        os.path.join(one, name)), got)

    # the RIPOR model scoring its own smtids
    qid_docids = {q: list(dd)[:sz["cli_self_docs"]] for q, dd in run.items()}
    with open(os.path.join(tmp, "qid_docids10.json"), "w") as f:
        json.dump(qid_docids, f)
    d2s = os.path.join(ws, "docid_to_smtid.json")
    self_dir = os.path.join(tmp, "self10")
    t0 = time.monotonic()
    rerank_cli(["rerank-task", "--task",
                "query_to_docid_rerank_for_qid_smtids", "--tokenizer",
                os.path.join(ws, "tokenizer.json"), "--queries", qdir,
                "--input-json", os.path.join(tmp, "qid_docids10.json"),
                "--docid-to-smtid", d2s, "--workspace", ws, "--out-dir",
                self_dir, *length] + devf, "self-rerank", repo)
    self_s = time.monotonic() - t0
    out = rerank_cli(["rerank-task-merge", "--task",
                      "query_to_docid_rerank_for_qid_smtids", "--out-dir",
                      self_dir, "--docid-to-smtid", d2s, "--qrel",
                      os.path.join(tmp, "qrel.json")], "self-rerank merge",
                     repo)
    with open(os.path.join(self_dir, "qid_smtids_rerank.json")) as f:
        got_self = json.load(f)
    with open(os.path.join(self_dir, "metric.json")) as f:
        metric = json.load(f)
    docids, codes = load_docid_to_smtid(d2s)
    d2c = dict(zip(docids, codes))
    want_self = rerank_query_smtids(
        world["cfg"], load_params(os.path.join(ws, "checkpoints", "final")),
        tok, queries, {q: sorted({smtid_to_str(d2c[d]) for d in dd})
                       for q, dd in sorted(qid_docids.items())},
        max_length=sz["cli_len"], device=dev)
    top = max(abs(v) for d in want_self.values() for v in d.values())
    check(sorted(got_self) == sorted(want_self) and all(
        got_self[q].keys() == want_self[q].keys()
        and max(abs(got_self[q][s] - v) for s, v in want_self[q].items())
        <= 1e-5 * max(1.0, top) for q in want_self),
        "10d self-rerank vs rerank_query_smtids")
    check(set(metric) == {"mrr_at_10", "mrr_at_100"}, f"10d metric {metric}")
    print("teacher_cli", json.dumps({
        "bce_rows": len(rows), "train_steps": len(rows) // sz["cli_b"],
        "docs_written": len(cands), "pairs": len(pairs),
        "vocab": tok.vocab_size, "train_process_s": train_s,
        "rerank_process_s": rerank_s, "two_ranks_s": ranks_s,
        "self_rerank_process_s": self_s, "self_rerank_metric": metric}))


def teacher_phase(world, tmp, sz=P10):
    """Phase 10: (a) teacher_forwards, (b) teacher_scoring, (c)
    teacher_training, (d) teacher_cli — float32 with TF32 off; no kernel
    of the port lies on this path."""
    import torch
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; phase 10 runs in float32")
    t0 = time.monotonic()
    teacher_forwards(sz)
    teacher_scoring(sz, tmp)
    teacher_training(sz)
    teacher_cli(world, sz, tmp)
    print("phase10_s", time.monotonic() - t0)


# ---- phase 11: the pipeline — flywheel datagen, the full recipe, runner ----

# tests/test_full_recipe.py::RECIPE_KW, the JAX test's floors run
RECIPE_KW = dict(M=8, K=16, vocab_size=300, phase1_epochs=6,
                 teacher_epochs=12, s2s_epochs=40, mm_epochs=6,
                 phase3_epochs=12, num_beams=8, topk=20, batch_size=8,
                 seed=0, tokenizer_kind="word", teacher_lr=3e-3)
# ... and its floors (tests/test_full_recipe.py:71-75)
RECIPE_FLOORS = {"phase2": {"recall_10": 0.99, "mrr_10": 0.70},
                 "phase3": {"recall_10": 0.99, "mrr_10": 0.30}}
RECIPE_ARTIFACTS = (
    "bm25_run.json", "pretrain_trainset_0.jsonl", "dense_run_phase1_0.json",
    "pretrain_trainset_1.jsonl", "dense_run_phase1_1.json",
    "phase2_mm_trainset.jsonl", "qid_to_reldocid_to_score.json",
    "query_to_docid.train.jsonl", "dense_run_phase2.json")
RECIPE_CHECKPOINTS = ("phase1_pretrain", "phase1_pretrain_1", "bert_teacher",
                      "phase2_seq2seq", "phase2_margin_mse", "final")

# The full-width run of phase 11. A rehearsal at a tiny size on the CPU
# passes a smaller copy (every function below reads its sizes from here).
P11 = dict(
    device="cuda",
    # (a) datagen on phase 7's workspace: beam 100 at every prefix length
    # (the reference's flywheel decode, full_evaluate...sh:127-139), the
    # BERT teacher over a text for each of the corpus's docs
    beam=100, prefix_lengths=(4, 8, 16, 32), doc_words=(20, 60),
    # (b) run_full_recipe at ripor_base(M=32, K=256) (None below), the
    # teacher at MiniLM-L6 geometry, every epoch count at 1. One teacher
    # epoch leaves its pos-neg margin at rounding level (either sign), so
    # the margin gate is open: (b) tests the plumbing at full width, and
    # (c) the learning
    recipe_cfg=None, recipe_docs=2048, recipe_queries=64, recipe_vocab=4096,
    teacher_geometry=dict(d_model=384, num_layers=6, num_heads=12,
                          d_ff=1536, max_position=512),
    recipe_kw=dict(phase1_epochs=1, teacher_epochs=1, s2s_epochs=1,
                   mm_epochs=1, phase3_epochs=1, batch_size=16,
                   num_beams=100, topk=100, curriculum=(4, 8, 16, 32),
                   calibrate_teacher_scale=True, prefix_eval=(4, 8),
                   min_teacher_margin=float("-inf"),
                   tokenizer_kind="word", seed=SEED),
    # (c) the JAX test's floors run; (d) the runner over phase 7's
    # workspace
    floors_kw=RECIPE_KW, pipeline_beam=1000, pipeline_prefix_lengths=(4, 8),
)


def recipe_corpus(root, n_docs, n_queries, seed=SEED):
    """tests/test_full_recipe.py::corpus at n_docs docs and n_queries
    queries (24 and 8 there): docs of five random words from a list of
    twelve and a topic word; query q finds doc q * (n_docs // n_queries)
    by its topic and first word. Returns (docs_dir, queries_dir,
    qrel_path)."""
    import os
    rng = np.random.default_rng(seed)
    words = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel", "india", "juliet", "kilo", "lima"]
    docs_dir, queries_dir = (os.path.join(root, n) for n in ("docs",
                                                             "queries"))
    os.makedirs(docs_dir)
    os.makedirs(queries_dir)
    texts = []
    with open(os.path.join(docs_dir, "raw.tsv"), "w") as f:
        for i in range(n_docs):
            text = " ".join(rng.choice(words, 5)) + f" topic{i}"
            texts.append(text)
            f.write(f"d{i}\t{text}\n")
    qrel, step = {}, n_docs // n_queries
    with open(os.path.join(queries_dir, "raw.tsv"), "w") as f:
        for qi in range(n_queries):
            di = qi * step
            f.write(f"q{qi}\tfind topic{di} {texts[di].split()[0]}\n")
            qrel[f"q{qi}"] = {f"d{di}": 1}
    qrel_path = os.path.join(root, "qrel.json")
    with open(qrel_path, "w") as f:
        json.dump(qrel, f)
    return docs_dir, queries_dir, qrel_path


def lng_knp_file(ws, plen):
    import os
    return os.path.join(ws, f"lng_knp_qid_smtids_scores_{plen}.train.json")


def check_lng_knp(tag, got, plen, want=None, tol=1e-5):
    """A flywheel trainset (a list of examples): every smtid has ``plen``
    codes, every score is finite, smtid_4_scores present iff plen > 4;
    with ``want``, the same qids and per query the same smtids, every
    score column within tol * max(1, |score|)."""
    check(got, f"{tag}: no examples")
    for ex in got:
        check(len(ex["smtids"]) == len(ex["scores"]) > 0,
              f"{tag}: {ex['qid']} smtids and scores differ in length")
        check(all(len(s.split("_")) == plen for s in ex["smtids"]),
              f"{tag}: an smtid without {plen} codes")
        check(("smtid_4_scores" in ex) == (plen > 4),
              f"{tag}: smtid_4_scores {'missing' if plen > 4 else 'set'}")
        cols = [k for k in ex if k.endswith("scores")]
        check(all(np.isfinite(ex[k]).all() for k in cols),
              f"{tag}: non-finite score")
    if want is None:
        return
    g = {ex["qid"]: ex for ex in got}
    w = {ex["qid"]: ex for ex in want}
    check(sorted(g) == sorted(w), f"{tag}: qids differ")
    for q, we in w.items():
        ge = g[q]
        check(set(ge["smtids"]) == set(we["smtids"]),
              f"{tag}: {q} smtids differ")
        for col in (k for k in we if k.endswith("scores")):
            gs = dict(zip(ge["smtids"], ge[col]))
            err = max(abs(gs[s] - v) / max(1.0, abs(v))
                      for s, v in zip(we["smtids"], we[col]))
            check(err <= tol, f"{tag}: {q} {col} differ by {err}")


def datagen_check(world, phase11, tmp, sz):
    """Phase 11 (a): datagen_round on phase 7's workspace (its
    checkpoint, 100,000-doc codes, 16 queries) over phase 10's teacher
    trainset (16 queries x 100 docids), at beam 100 and prefix lengths
    4/8/16/32, with the self teacher and the bert teacher (phase 10's
    bert_bce checkpoint; a text for every docid of the corpus, written to
    ``tmp``/docs11, since the beams reach any prefix group), with the
    counters zeroed just before and read just after: K1-K3 must launch.
    Returns each round's examples by (teacher, prefix length): (d) holds
    CLI ``datagen`` against them."""
    import os

    import torch
    from ripor_tpu_torch.data.datasets import Collection, load_docid_to_smtid
    from ripor_tpu_torch.evaluation.reranker import (load_bert_teacher,
                                                     rerank_pairs,
                                                     self_rerank_pair_scores)
    from ripor_tpu_torch.models import RiporConfig
    from ripor_tpu_torch.pipeline import load_tokenizer
    from ripor_tpu_torch.pipeline.flywheel import datagen_round, search_model
    from ripor_tpu_torch.train import load_params

    dev = sz["device"]
    ws, qdir = os.path.join(tmp, "ws"), os.path.join(tmp, "queries")
    trainset = os.path.join(tmp, "teacher_trainset.jsonl")
    teacher = os.path.join(ws, "checkpoints", "teacher")
    rng = np.random.default_rng(SEED + 11)
    docs_dir = os.path.join(tmp, "docs11")
    os.makedirs(docs_dir)
    lo, hi = sz["doc_words"]
    t0 = time.monotonic()
    words = np.asarray(world["words"])
    with open(os.path.join(docs_dir, "raw.tsv"), "w") as f:
        for d in world["docids"]:
            pick = rng.integers(0, len(words), rng.integers(lo, hi + 1))
            f.write(f"{d}\t{' '.join(words[pick])}\n")
    docs_s = time.monotonic() - t0
    ckpt = os.path.join(ws, "checkpoints", "final")
    cfg = RiporConfig.load(os.path.join(ckpt, "config.json"))
    params = load_params(ckpt)
    tok = load_tokenizer(os.path.join(ws, "tokenizer.json"))
    docids, codes = load_docid_to_smtid(os.path.join(ws, "docid_to_smtid.json"))
    d2c = dict(zip(docids, codes))
    queries = Collection(qdir)
    with open(trainset) as f:
        q2d = {str(ex["qid"]): [str(d) for d in ex["docids"]]
               for ex in map(json.loads, f)}
    docs = Collection(docs_dir)
    bert_fn = load_bert_teacher(teacher, tok.vocab_size, device=dev)
    scorers = {
        "self": lambda pairs: self_rerank_pair_scores(
            cfg, params, tok, queries, d2c, pairs, batch_size=32,
            max_length=64, device=dev),
        "bert": lambda pairs: rerank_pairs(bert_fn, tok, queries, docs,
                                           pairs, batch_size=32,
                                           max_length=64)}
    searcher = search_model(cfg, params, torch.bfloat16, dev)
    rounds, merged_by = [], {}
    zero_launches()
    for name, score in scorers.items():
        for plen in sz["prefix_lengths"]:
            n_pairs = []

            def counted(pairs):
                n_pairs.append(len(pairs))
                return score(pairs)
            t0 = time.monotonic()
            merged = datagen_round(cfg, searcher, tok, queries, q2d, codes,
                                   docids, counted, prefix_len=plen,
                                   num_beams=sz["beam"], batch_size=4,
                                   device=dev)
            sync(dev)
            rounds.append({"teacher": name, "prefix_len": plen,
                           "seconds": time.monotonic() - t0,
                           "pairs_scored": n_pairs[0],
                           "examples": len(merged)})
            merged_by[name, plen] = list(map(dict, merged))
            check_lng_knp(f"11a {name} p{plen}", merged_by[name, plen], plen)
    launched = need_launches("11a datagen_round", MEGAROW_KERNELS, phase11)
    # the steps that phase 2 checks (pipeline_searches) are these rounds'
    want = sum_counts(decode_launches(cfg.t5.num_decoder_layers, p,
                                      len(scorers) * -(-len(q2d) // 4))
                      for p in sz["prefix_lengths"])
    check(launched == want, f"11a: launches {launched}, not {want}")
    del searcher, bert_fn
    torch.cuda.empty_cache()
    print("pipeline_datagen", json.dumps({
        "queries": len(q2d), "docids_a_query": max(map(len, q2d.values())),
        "beam": sz["beam"], "docs_written": len(world["docids"]),
        "docs_s": docs_s, "in_process": rounds,
        "launches": launched}))
    return merged_by


def recipe_run(ws, docs_dir, queries_dir, qrel_path, **kw):
    """run_full_recipe with its workspace log recorded: -> (metrics,
    [(monotonic seconds, message)], the printed output)."""
    import contextlib
    import io

    from ripor_tpu_torch.pipeline import recipe
    from ripor_tpu_torch.pipeline.full_recipe import run_full_recipe
    records, buf = [], io.StringIO()
    log = recipe.Workspace.log

    def recording(self, msg):
        records.append((time.monotonic(), msg))
        log(self, msg)
    recipe.Workspace.log = recording
    try:
        with contextlib.redirect_stdout(buf):
            metrics = run_full_recipe(ws, docs_dir, queries_dir, qrel_path,
                                      **kw)
    finally:
        recipe.Workspace.log = log
    return metrics, records, buf.getvalue()


def stage_seconds(records, t_end):
    """Seconds from each workspace-log message to the next, summed by the
    stage that message names (its text before ': ', ' (' or ' step ')."""
    import re
    out = {}
    for (t, msg), t_next in zip(records, [t for t, _ in records[1:]]
                                + [t_end]):
        key = re.split(r": | \(| step \d", msg, maxsplit=1)[0][:60]
        out[key] = out.get(key, 0.0) + (t_next - t)
    return out


def check_metrics(tag, metrics, keys):
    check(sorted(metrics) == sorted(keys), f"{tag}: metrics {sorted(metrics)}")
    for k, m in metrics.items():
        check(set(m) == {"mrr_10", "recall_10", "recall_100"}
              and all(np.isfinite(v) and 0 <= v <= 1 for v in m.values()),
              f"{tag}: {k} {m}")


def recipe_check(world, phase11, tmp, sz):
    """Phase 11 (b): run_full_recipe at full width on the card: a
    ripor_base(M=32, K=256) student from init_params, the BertCrossEncoder
    teacher at MiniLM-L6 geometry, tests/test_full_recipe.py's corpus at
    2,048 docs and 64 queries with the word tokenizer, every epoch count
    1, batch 16, beam = topk = 100, curriculum 4/8/16/32, teacher-scale
    calibration, prefix_eval (4, 8). Counters zeroed just before and read
    just after: K1-K3 must launch. Every artifact and checkpoint of
    tests/test_full_recipe.py::test_full_recipe_runs_and_holds_floors;
    finite metrics. Prints the seconds of each stage from the workspace
    log. (c) resumes the recipe.)"""
    import os

    import torch
    from ripor_tpu_torch.models import ripor_base
    from ripor_tpu_torch.pipeline.flywheel import read_jsonl

    dev = sz["device"]
    root = os.path.join(tmp, "recipe11")
    os.makedirs(root)
    corpus = recipe_corpus(root, sz["recipe_docs"], sz["recipe_queries"])
    ws = os.path.join(root, "ws")
    cfg = sz["recipe_cfg"] or ripor_base(M=M, K=K)
    kw = dict(sz["recipe_kw"], cfg=cfg, vocab_size=sz["recipe_vocab"],
              teacher_geometry=sz["teacher_geometry"], device=dev)
    zero_launches()
    t0 = time.monotonic()
    metrics, records, _ = recipe_run(ws, *corpus, **kw)
    sync(dev)
    run_s = time.monotonic() - t0
    launched = need_launches("11b run_full_recipe", MEGAROW_KERNELS, phase11)
    plens = list(kw["curriculum"])
    # datagen_round at batch 4 over every query, stage_retrieve at batch 8
    # after phases 2 and 3: the searches of pipeline_searches
    nq, Lw = sz["recipe_queries"], cfg.t5.num_decoder_layers
    want = sum_counts(
        [decode_launches(Lw, p, -(-nq // 4)) for p in plens]
        + [decode_launches(Lw, p, 2 * -(-nq // 8))
           for p in (cfg.M, *kw["prefix_eval"])])
    check(launched == want, f"11b: launches {launched}, not {want}")
    check_metrics("11b", metrics, [f"phase{p}{s}" for p in (2, 3)
                                   for s in [""] + [f"_prefix{e}" for e in
                                                    kw["prefix_eval"]]])
    for name in RECIPE_ARTIFACTS + tuple(
            os.path.basename(lng_knp_file(ws, p)) for p in plens):
        check(os.path.exists(os.path.join(ws, name)), f"11b: no {name}")
    for name in RECIPE_CHECKPOINTS + tuple(f"phase3_mnt_{p}" for p in plens):
        check(os.path.exists(os.path.join(ws, "checkpoints", name,
                                          "params.pt")),
              f"11b: no checkpoint {name}")
    rows = read_jsonl(os.path.join(ws, "pretrain_trainset_0.jsonl"))
    check(rows and all(len(r["docids"]) == len(r["scores"]) >= 2
                       and r["scores"][1:] == sorted(r["scores"][1:],
                                                     reverse=True)
                       for r in rows), "11b: pretrain trainset rows")
    for p in plens:
        check_lng_knp(f"11b p{p}", read_jsonl(lng_knp_file(ws, p)), p)
    stages = stage_seconds(records, time.monotonic())
    torch.cuda.empty_cache()
    with open(os.path.join(ws, "checkpoints", "bert_teacher",
                           "teacher_quality.json")) as f:
        quality = json.load(f)
    print("pipeline_recipe", json.dumps({
        "docs": sz["recipe_docs"], "queries": sz["recipe_queries"],
        "d_model": cfg.t5.d_model, "layers": cfg.t5.num_layers, "M": cfg.M,
        "K": cfg.K, "teacher": sz["teacher_geometry"], "seconds": run_s,
        "metrics": metrics,
        "teacher_quality": quality, "launches": launched,
        "stage_s": stages}))


def floors_check(tmp, sz):
    """Phase 11 (c): ``full-recipe`` as a process of its own at
    tests/test_full_recipe.py::RECIPE_KW on its 24-doc corpus, on the
    card: phases 2 and 3 must reach that test's floors. A second call on
    the same workspace restores every stage's checkpoint: it must return
    the same metrics and neither train nor generate data."""
    import os
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "floors11")
    os.makedirs(root)
    docs_dir, queries_dir, qrel_path = recipe_corpus(root, 24, 8)
    conf = os.path.join(root, "recipe_kw.json")
    with open(conf, "w") as f:
        json.dump(sz["floors_kw"], f)
    argv = ["full-recipe", "--workspace", os.path.join(root, "ws"),
            "--docs", docs_dir, "--queries", queries_dir, "--qrel",
            qrel_path, "--config", conf, "--device", sz["device"]]

    def run(tag):
        out = rerank_cli(argv, tag, repo)
        lines = out.splitlines()
        start = max(i for i, ln in enumerate(lines) if ln == "{")
        return json.loads("\n".join(lines[start:])), out
    t0 = time.monotonic()
    metrics, _ = run("full-recipe")
    process_s = time.monotonic() - t0
    check_metrics("11c", metrics, ["phase2", "phase3"])
    t0 = time.monotonic()
    again, out = run("full-recipe resumed")
    resume_s = time.monotonic() - t0
    check(list(again) == list(metrics) and all(
        abs(again[t][k] - v) <= 1e-6 for t, m in metrics.items()
        for k, v in m.items()), f"11c resume: {again} != {metrics}")
    check("restoring existing checkpoint" in out
          and ": training" not in out and "datagen at prefix" not in out,
          "11c resume trained or generated data again")
    for phase, floors in RECIPE_FLOORS.items():
        for k, floor in floors.items():
            check(metrics[phase][k] >= floor,
                  f"11c: {phase} {k} {metrics[phase][k]} below {floor}")
    print("pipeline_floors", json.dumps({
        "metrics": metrics, "floors": RECIPE_FLOORS,
        "process_s": process_s, "resume_s": resume_s}))


def runner_check(world, phase11, tmp, sz, rounds):
    """Phase 11 (d): ``pipeline`` over phase 7's workspace: retrieve (beam
    1000) -> evaluate -> datagen (self teacher). The second run runs no
    stage, ``--from evaluate`` re-runs the last two; retrieve and evaluate
    equal the subcommand run directly, and datagen's files (a)'s
    datagen_round at each prefix length (``rounds``, same smtids, scores
    within 1e-5). Then CLI ``datagen --teacher bert`` as a process of its
    own at the first prefix length, held against (a)'s bert round."""
    import os

    from ripor_tpu_torch.pipeline.flywheel import read_jsonl
    ws, qdir = os.path.join(tmp, "ws"), os.path.join(tmp, "queries")
    dev = ["--device", sz["device"]]
    retrieve = ["retrieve", "--workspace", ws, "--queries", qdir, "--beam",
                str(sz["pipeline_beam"]), "--topk", str(sz["pipeline_beam"])]
    evaluate = ["evaluate", "--qrel", os.path.join(tmp, "qrel.json"),
                "--run", os.path.join(ws, "run11.json")]
    plens = sz["pipeline_prefix_lengths"]
    datagen = ["datagen", "--workspace", ws, "--queries", qdir,
               "--teacher-trainset", os.path.join(tmp, "teacher_trainset.jsonl"),
               "--beam", str(sz["beam"]), "--prefix-lengths",
               *map(str, plens)]
    spec = os.path.join(tmp, "pipeline11.json")
    with open(spec, "w") as f:
        json.dump({"workspace": ws, "stages": [
            {"name": "retrieve", "argv": retrieve + ["--run-name",
                                                     "run11.json"],
             "outputs": [os.path.join(ws, "run11.json")]},
            {"name": "evaluate", "argv": evaluate},
            {"name": "datagen", "argv": datagen,
             "outputs": [lng_knp_file(ws, plens[-1])]}]}, f)
    cmd = ["pipeline", "--config", spec] + dev
    ran, outs = [], []
    t0 = time.monotonic()
    for extra in ([], [], ["--from", "evaluate"]):
        out = run_cli(cmd + extra, "pipeline")
        ran.append(int(out.split("pipeline complete (")[1].split()[0]))
        outs.append(out)
    pipeline_s = time.monotonic() - t0
    check(ran == [3, 0, 2], f"11d: stages ran {ran}, not [3, 0, 2]")
    mrr = [json.loads(o[o.index("{\n"):o.index("\n}") + 2])
           for o in (outs[0], outs[2])]
    files = {p: read_jsonl(lng_knp_file(ws, p)) for p in plens}
    run_cli(retrieve + ["--run-name", "run11_direct.json"] + dev,
            "direct retrieve")
    check_same_run("11d retrieve", read_run(os.path.join(ws,
                                                         "run11_direct.json")),
                   read_run(os.path.join(ws, "run11.json")))
    direct = json.loads(run_cli(evaluate, "direct evaluate"))
    check(mrr == [direct, direct], f"11d evaluate: {mrr} vs {direct}")
    for p in plens:
        check_lng_knp(f"11d p{p}", files[p], p, want=rounds["self", p])
    repo = os.path.dirname(os.path.abspath(__file__))
    bert = ["--teacher", "bert", "--teacher-ckpt",
            os.path.join(ws, "checkpoints", "teacher"), "--docs",
            os.path.join(tmp, "docs11")]
    t0 = time.monotonic()
    rerank_cli(datagen[:-len(plens)] + [str(plens[0])] + bert + dev,
               "datagen bert", repo)
    bert_s = time.monotonic() - t0
    check_lng_knp(f"11d bert p{plens[0]}",
                  read_jsonl(lng_knp_file(ws, plens[0])), plens[0],
                  want=rounds["bert", plens[0]])
    print("pipeline_runner", json.dumps({
        "stages_ran": ran, "mrr": direct, "seconds": pipeline_s,
        "datagen_bert_process_s": bert_s}))


def pipeline_phase(world, phase11, tmp, sz=P11):
    """Phase 11: (a) datagen_check, (b) recipe_check, (c) floors_check,
    (d) runner_check; the launches of K1-K3 in (a)'s and (b)'s runs go to
    ``phase11``."""
    t0 = time.monotonic()
    parts, rounds = {}, {}
    for name, fn in (("a", lambda: rounds.update(
                          datagen_check(world, phase11, tmp, sz))),
                     ("b", lambda: recipe_check(world, phase11, tmp, sz)),
                     ("c", lambda: floors_check(tmp, sz)),
                     ("d", lambda: runner_check(world, phase11, tmp, sz,
                                                rounds))):
        t1 = time.monotonic()
        fn()
        parts[name] = time.monotonic() - t1
    print("phase11_s", json.dumps({"total": time.monotonic() - t0,
                                   **parts}))


# ---- phase 12: the mesh — data- and tensor-parallel decode ----

# The full-width run of phase 12. A rehearsal at a tiny size on the CPU
# passes dict(P12, device="cpu", <small sizes>) with a small world.
P12 = dict(device="cuda", beam=1000, batch=8, quant="int4",
           dense_rows=1_000_000, dense_dim=768, dense_queries=64,
           dense_k=1000, timeout=480,
           # (e) trains this config (None: ripor_base(M=32, K=256))
           train_cfg=None)
# The TP searches at tests/test_sharded_decode.py's geometry
# (ripor_small(M=4, K=8), f32, 5 beams, 8 queries of 9 tokens, 60 docs),
# with that test's bars: (search kwargs, rtol, atol, states compared)
TOY_TP = {"exact": (dict(megarow=True, cache_segments=2), 2e-5, 1e-5, True),
          "int4": (dict(megarow=True, cache_segments=2,
                        kv_cache_quant="int4"), 1e-4, 1e-3, False)}


def toy_world():
    """Phase 12's small TP geometry (TOY_TP), from the seed: (cfg, f32
    state_dict on the CPU, ids, mask, trie)."""
    import torch
    from ripor_tpu_torch.models import init_params, ripor_small
    from ripor_tpu_torch.trie import build_trie
    cfg = ripor_small(M=4, K=8)
    sd = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    rng = np.random.default_rng(SEED)
    ids = rng.integers(1, 90, (8, 9)).astype(np.int32)
    return cfg, sd, ids, np.ones_like(ids), build_trie(
        rng.integers(0, 8, (60, 4)), 8)


def mesh_rank(rank, world_size, tmp):
    """One rank of phase 12 (``chip_smoke.py --mesh-rank R W TMP``): joins
    the gloo world on a FileStore in ``tmp``, loads the world the parent
    saved there, and runs (a) the data-parallel search (data=2), (b) the
    tensor-parallel search (model=2), each once to warm up and once with
    the launch counters zeroed just before and read just after, and the
    TP search in f32 on an exact cache once, counted the same way (its
    time includes the build of the rank's model); the all-reduces of one
    TP step alone; the TP searches at TOY_TP's geometry; then (c)
    RetrievalEngine(mesh=) and dense_topk(mesh=) at data=2, between them
    (d) that engine served (serve_on_mesh), and (e) train_on_mesh. Writes its results to ``tmp/rank<R>.pkl``."""
    import os
    import pickle

    import torch
    from ripor_tpu_torch.core.mesh import (MODEL_AXIS, MeshSpec,
                                           all_reduce_sum, create_mesh,
                                           distributed_init)
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.decode.beam import (make_sharded_beam_search_fn,
                                             make_tp_beam_search_fn)
    from ripor_tpu_torch.evaluation.retriever import dense_topk
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import succinct_tables, tables_to_torch

    with open(os.path.join(tmp, "world.pkl"), "rb") as f:
        w = pickle.load(f)
    sz, dev = w["sz"], w["sz"]["device"]
    if dev == "cuda":
        torch.cuda.set_device(0)
        from ripor_tpu_torch.ops import _build
        _build.build_all()
    distributed_init(f"file://{os.path.join(tmp, 'store')}",
                     num_processes=world_size, process_id=rank,
                     backend="gloo")
    cfg = w["cfg"]
    sd = {k: v.to(dev) for k, v in w["sd"].items()}
    model = RiporModel(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(sd)
    tables = tables_to_torch(succinct_tables(w["trie"]), dev)
    Bq = sz["batch"]
    ids, mask = tokenize_queries(w["tok"], w["queries"][:Bq], 64)
    out = {}
    meshes = {"dp": create_mesh(MeshSpec(data=world_size), dev),
              "tp": create_mesh(MeshSpec(data=1, model=world_size), dev)}
    for part, make, dtype in (
            ("dp", make_sharded_beam_search_fn, torch.bfloat16),
            ("tp", make_tp_beam_search_fn, torch.bfloat16),
            ("tp_f32", make_tp_beam_search_fn, torch.float32)):
        fn = make(cfg, sz["beam"], meshes[part[:2]],
                  kv_cache_quant=None if part == "tp_f32" else sz["quant"],
                  dtype=dtype, device=dev)
        params = model if part == "dp" else sd
        if part != "tp_f32":
            # a warm-up on two queries; for TP it builds the rank's
            # model, which the timed call reuses
            fn(params, ids[:2], mask[:2], tables)
        sync(dev)
        zero_launches()
        t0 = time.monotonic()
        res = tuple(a.cpu().numpy() for a in fn(params, ids, mask, tables))
        dt = time.monotonic() - t0
        out[part] = dict(res=res, s=dt, ms_per_step=dt / cfg.M * 1e3,
                         launches={k: n for k, n in KERNEL_LAUNCHES.items()
                                   if n})
        del fn
        if dev == "cuda":
            torch.cuda.empty_cache()
    # the all-reduces of one TP decode step alone (3 a decoder layer) on
    # its [B, N, d] bf16 activations, over the model group
    n_red = 3 * cfg.t5.num_decoder_layers
    x = torch.zeros(Bq, sz["beam"], cfg.t5.d_model, dtype=torch.bfloat16,
                    device=dev)
    group = meshes["tp"].get_group(MODEL_AXIS)
    all_reduce_sum(x, group)
    sync(dev)
    t0 = time.monotonic()
    for _ in range(n_red):
        all_reduce_sum(x, group)
    sync(dev)
    out["all_reduce_ms"] = (time.monotonic() - t0) / n_red * 1e3
    out["all_reduces_per_step"] = n_red
    tcfg, tsd, tids, tmask, ttrie = w["toy"]
    ttables = tables_to_torch(succinct_tables(ttrie), dev)
    tsd = {k: v.to(dev) for k, v in tsd.items()}
    for name, (kw, *_) in TOY_TP.items():
        fn = make_tp_beam_search_fn(tcfg, 5, meshes["tp"],
                                    dtype=torch.float32, device=dev, **kw)
        out[f"toy_{name}"] = tuple(a.cpu().numpy()
                                   for a in fn(tsd, tids, tmask, ttables))
    eng = RetrievalEngine(
        cfg, sd, w["tok"], w["trie"], w["docids"],
        ServeConfig(num_beams=sz["beam"], topk=sz["beam"], batch_sizes=(Bq,),
                    kv_cache_quant=sz["quant"]),
        mesh=meshes["dp"], device=dev)
    out["engine"] = eng.retrieve_batch(w["queries"][:Bq])
    out["serve"] = serve_on_mesh(eng, w["queries"][:Bq])
    del eng
    q, corpus = dense_inputs(sz)
    t0 = time.monotonic()
    out["dense"] = dense_topk(q, corpus, sz["dense_k"], mesh=meshes["dp"])
    out["dense_s"] = time.monotonic() - t0
    del q, corpus
    if dev == "cuda":
        torch.cuda.empty_cache()
    out["train"] = train_on_mesh(w, meshes["dp"], tmp, dev)
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def post_queries(port, queries):
    """POST /retrieve on loopback -> (status, results as (docid, score)
    lists, seconds)."""
    import http.client
    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/retrieve", json.dumps({"queries": queries}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return (resp.status, [[(d, v) for d, v in r] for r in
                          body.get("results", [])], time.monotonic() - t0)


def serve_on_mesh(eng, queries):
    """Phase 12 (d) on one rank: serve_http on every rank (rank 0 serves,
    the other follows its batches), rank 0 posts ``queries`` one by one,
    then as one batch, then submits them all at once; then every rank
    stops the engine. The launch counters are zeroed just before and
    read just after."""
    import threading

    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.serve.http import serve_http

    hist0 = sum(eng.stats()["batch_hist"].values())
    zero_launches()
    t0 = time.monotonic()
    server = serve_http(eng, port=0, block=False)
    out = {}
    if server is not None:
        port = server.server_address[1]
        out["http_single"] = [post_queries(port, [q]) for q in queries]
        out["http_batch"] = post_queries(port, queries)
        futures = [eng.submit(q) for q in queries]
        out["submit"] = [f.result(timeout=600) for f in futures]
        st = eng.stats()
        out["batches"] = sum(st["batch_hist"].values()) - hist0
        out["stats_p50_s"] = st["p50_s"]
        server.shutdown()
        server.server_close()
    t1 = time.monotonic()
    eng.stop()
    out["stop_s"] = time.monotonic() - t1
    out["s"] = time.monotonic() - t0
    out["threads_left"] = [t.name for t in threading.enumerate()
                           if t.name.startswith("ripor-")]
    out["launches"] = {k: n for k, n in KERNEL_LAUNCHES.items() if n}
    return out


def params_checksum(params):
    return float(sum(p.detach().double().abs().sum() for p in
                     params.values()))


def train_on_mesh(w, mesh, root, dev):
    """Phase 12 (e) on one rank: Trainer(mesh=) at data=2 and
    ``w["train_cfg"]`` (full t5-base width), f32, lng_knp_margin_mse over
    phase 8's batches (global B=16, 8 a rank). One step at dropout 0
    (rank 0 saves its params and all-reduced gradients for the parent),
    then 2 warm-up and 3 timed
    steps at dropout 0.1, replicated and with ZeRO: ms a step (the
    StepTimer's CUDA events), the collectives' ms a step (synced host
    time), peak memory and what the rank held before the Trainer, Adam
    moment bytes, and whether ZeRO's params are bit-equal to
    replicated."""
    import dataclasses
    import os

    import torch
    from ripor_tpu_torch.core.mesh import is_first_process
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.train import TrainConfig, Trainer

    cfg = w["train_cfg"]
    det = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, dropout_rate=0.0))
    sd = torch.load(os.path.join(root, "train_sd.pt"), mmap=True,
                    weights_only=True)
    batches = w["train"]
    tcfg = TrainConfig(loss_type=TRAIN_LOSS)
    out = {}
    t0 = time.monotonic()
    trainer = Trainer(RiporModel(det, device=dev), tcfg, sd, mesh=mesh)
    _, metrics = trainer.run(batches[:1], seed=SEED)
    out["step"] = {k: float(v) for k, v in metrics.items()}
    out["step_checksum"] = params_checksum(trainer.state.params)
    if is_first_process():
        torch.save({"params": {k: p.detach().cpu() for k, p in
                               trainer.state.params.items()},
                    "grads": {k: p.grad.cpu() for k, p in
                              trainer.state.params.items()}},
                   os.path.join(root, "mesh_step.pt"))
    out["step_s"] = time.monotonic() - t0
    del trainer
    final = None
    for label, tc in (("replicated", tcfg),
                      ("zero", dataclasses.replace(tcfg,
                                                   shard_opt_state=True))):
        reset_peak(dev)
        held = (torch.cuda.memory_allocated() / 1e9 if dev == "cuda"
                else "not measured")
        logs, coll = [], []
        trainer = None

        def log(m, step):
            logs.append({k: float(v) for k, v in m.items()})
            coll.append(trainer.dp.collective_s)
        trainer = Trainer(RiporModel(cfg, device=dev), tc, sd, mesh=mesh,
                          log_fn=log)
        t1 = time.monotonic()
        trainer.run(batches[:5], seed=SEED, log_every=1)
        sync(dev)
        params = trainer.state.params
        rec = {"wall_s": time.monotonic() - t1,
               "ms_per_step_median": logs[-1]["p50_s"] * 1e3,
               "ms_per_step_mean": logs[-1]["mean_s"] * 1e3,
               "steps_timed": logs[-1]["steps"],
               "collective_ms_per_step": (coll[-1] - coll[1]) / 3 * 1e3,
               "peak_memory_gb": peak_gb(dev),
               "memory_held_before_gb": held,
               # the bytes the moments' storage holds (a view of a
               # larger tensor would hold all of it)
               "moment_gb": sum({t.untyped_storage().data_ptr():
                                 t.untyped_storage().nbytes()
                                 for m in ("mu", "nu") for t in
                                 trainer.state.opt_state[m].values()
                                 }.values()) / 1e9,
               "checksum": params_checksum(params),
               "losses": [m["loss"] for m in logs]}
        rec["collective_share"] = (rec["collective_ms_per_step"]
                                   / rec["ms_per_step_mean"])
        if final is None:
            # on the host, so that ZeRO's peak is not charged for it
            final = {k: p.detach().cpu() for k, p in params.items()}
        else:
            rec["bit_equal_to_replicated"] = all(
                torch.equal(p.cpu(), final[k]) for k, p in params.items())
        out[label] = rec
        del trainer, params
    reset_peak(dev)
    return out


def dense_inputs(sz):
    """Phase 12's dense queries (numpy) and bf16 corpus on the device, made
    from the seed where they live."""
    import torch
    g = torch.Generator(device=sz["device"]).manual_seed(SEED)
    corpus = torch.randn(sz["dense_rows"], sz["dense_dim"], generator=g,
                         device=sz["device"]).to(torch.bfloat16)
    q = torch.randn(sz["dense_queries"], sz["dense_dim"], generator=g,
                    device=sz["device"])
    return q.cpu().numpy(), corpus


def live_equal(a, b, live):
    return bool(np.array_equal(a[live], b[live]))


def train_reference(cfg, batch, sd, dev):
    """Phase 12 (e)'s references, one-process Trainer steps at dropout 0
    on one model: on the global batch -> (metrics, params, gradients) on
    the host; the mean of the gradients of its two halves (each rank's
    rows), summed on the host and halved as the ranks' all-reduce does;
    and the params after one AdamW update from ``sd`` by that mean (what
    the mesh's step must give)."""
    import dataclasses

    import torch
    from ripor_tpu_torch.models import RiporModel
    from ripor_tpu_torch.train import TrainConfig, Trainer, make_optimizer

    det = dataclasses.replace(cfg, t5=dataclasses.replace(
        cfg.t5, dropout_rate=0.0))
    tcfg = TrainConfig(loss_type=TRAIN_LOSS)
    model = RiporModel(det, device=dev)
    half = len(batch["query_ids"]) // 2
    out = []
    for part in (batch, {k: v[:half] for k, v in batch.items()},
                 {k: v[half:] for k, v in batch.items()}):
        trainer = Trainer(model, tcfg, sd)
        _, metrics = trainer.run([part], seed=SEED)
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: p.detach().cpu() for k, p in
                     trainer.state.params.items()},
                    {k: p.grad.cpu() for k, p in
                     trainer.state.params.items()}))
        del trainer
        reset_peak(dev)
    (metrics, params, grads), (_, _, g0), (_, _, g1) = out
    halves = {k: (g0[k] + g1[k]).div_(2) for k in g0}
    model.load_state_dict(sd)
    named = dict(model.named_parameters())
    tx = make_optimizer(tcfg)
    with torch.no_grad():
        tx.update({k: g.to(dev) for k, g in halves.items()},
                  tx.init(named), named)
    stepped = {k: p.detach().cpu() for k, p in named.items()}
    del model, named
    reset_peak(dev)
    return metrics, params, grads, halves, stepped


def grad_gaps(got, want):
    """max |got - want| over max |want| of each gradient tensor, largest
    first."""
    gaps = {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
            for k, w in want.items()}
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def check_engine_bar(tag, got, want):
    """Phase 12 (c)'s int4 bar on engine results: top docid equal, docid
    sets differing by at most one, scores within 0.25 + 0.05 |score|.
    Returns each query's docid-set difference."""
    check(len(got) == len(want), f"{tag}: result count")
    diff = []
    for g_, w_ in zip(got, want):
        check(g_[0][0] == w_[0][0], f"{tag}: top docid")
        docs_g, docs_w = {d for d, _ in g_}, {d for d, _ in w_}
        diff.append(min(len(docs_g), len(docs_w)) - len(docs_g & docs_w))
        sg, sw = np.array([v for _, v in g_]), np.array([v for _, v in w_])
        n = min(len(sg), len(sw))
        check(np.all(np.abs(sg[:n] - sw[:n]) <= 0.25 + 0.05 * np.abs(sw[:n])),
              f"{tag}: scores")
    check(max(diff) <= 1, f"{tag}: docid sets {diff}")
    return diff


def check_mesh_serving(outs, ref_engine, cfg, phase12):
    """Phase 12 (d)'s checks: HTTP (one by one and batched) and submit on
    rank 0 equal to retrieve_batch on the mesh, and so within the int4 bar
    of the one-rank engine; every rank stopped, its threads gone, and
    launched the searches rank 0 served. Adds the launches to
    ``phase12``."""
    first = outs[0]["serve"]
    want = outs[0]["engine"]
    single = [r for status, res, _ in first["http_single"]
              for r in res]
    check(all(status == 200 for status, _, _ in first["http_single"])
          and first["http_batch"][0] == 200, "12d: HTTP status")
    for tag, got in (("http one by one", single),
                     ("http batch", first["http_batch"][1]),
                     ("submit", first["submit"])):
        check(got == want, f"12d {tag}: differs from retrieve_batch")
        check_engine_bar(f"12d {tag}", got, ref_engine)
    n = first["batches"]
    # the batch and the submits each coalesce into one or two batches
    check(len(single) + 2 <= n <= len(single) + 4,
          f"12d: {n} batches served")
    need = decode_launches(cfg.t5.num_decoder_layers, cfg.M, n)
    for r, o in enumerate(outs):
        check(o["serve"]["threads_left"] == [],
              f"12d rank {r}: threads left {o['serve']['threads_left']}")
        check(o["serve"]["launches"] == need,
              f"12d rank {r}: launches {o['serve']['launches']}, not {need}")
        for k, c in o["serve"]["launches"].items():
            phase12[k] = phase12.get(k, 0) + c
    lat = sorted(t for _, _, t in first["http_single"])
    return {"batches": n, "http_p50_ms": lat[len(lat) // 2] * 1e3,
            "http_batch_ms": first["http_batch"][2] * 1e3,
            "engine_p50_ms": first["stats_p50_s"] * 1e3,
            "stop_s": [o["serve"]["stop_s"] for o in outs],
            "seconds": [o["serve"]["s"] for o in outs],
            "launches_per_rank": outs[0]["serve"]["launches"]}


def check_mesh_training(outs, ref, root):
    """Phase 12 (e)'s checks against the one-process steps ``ref``
    (train_reference): losses within rtol 1e-5 and grad_norm within 1e-4
    of the global batch's; params within the JAX package's bar (rtol
    2e-4 / atol 1e-6, tests/test_train.py:283-284), or, where Adam's
    first step (which divides by |g|) turns rounding noise near eps into
    update noise past it, at most 1e-3 of them past it, each all-reduced
    gradient tensor within 1e-4 of its largest entry of the one-process
    mean of the two halves' gradients (the same sums: the global batch's
    gradient differs from that mean by the batch split's own rounding,
    reported as ``split_grad_gaps``), and every param within 1e-6 of one
    one-process AdamW update by that mean (the update itself: step
    count, bias correction, weight decay, schedule); every rank's params
    equal; ZeRO bit-equal to replicated with about half the moment
    bytes."""
    import os

    import torch

    metrics, params, grads, halves, stepped = ref
    got = torch.load(os.path.join(root, "mesh_step.pt"), weights_only=True)
    step = outs[0]["train"]["step"]
    check(set(step) == set(metrics), f"12e metrics {sorted(step)}")
    rel = {k: abs(step[k] - v) / max(abs(v), 1e-30)
           for k, v in metrics.items()}
    check(max(v for k, v in rel.items() if k != "grad_norm") <= 1e-5
          and rel["grad_norm"] <= 1e-4, f"12e: step metrics {rel}")
    agree = param_agreement(got["params"], params, rtol=2e-4, atol=1e-6)
    update = param_agreement(got["params"], stepped, rtol=0.0, atol=1e-6)
    gaps = grad_gaps(got["grads"], halves)
    split = grad_gaps(halves, grads)
    mesh_full = grad_gaps(got["grads"], grads)
    rec = {"step": step, "rel_diff": rel, "params": agree,
           "params_to_halves_update": update,
           "grad_gaps_to_halves": dict(list(gaps.items())[:5]),
           "grad_gaps_to_global": dict(list(mesh_full.items())[:5]),
           "split_grad_gaps": dict(list(split.items())[:5])}
    print("mesh_train_parity", json.dumps(rec))
    check(agree["loose_share"] == 0
          or (agree["loose_share"] <= 1e-3 and max(gaps.values()) <= 1e-4
              and update["loose_share"] == 0),
          f"12e: params {agree}, against the halves' update {update}, "
          f"gradients {list(gaps.items())[:3]}")
    check(len({o["train"]["step_checksum"] for o in outs}) == 1,
          "12e: ranks' params differ after the step")
    for label in ("replicated", "zero"):
        recs = [o["train"][label] for o in outs]
        check(len({r["checksum"] for r in recs}) == 1,
              f"12e {label}: ranks' params differ")
        check(all(np.isfinite(r["losses"]).all() for r in recs),
              f"12e {label}: a loss is not finite")
        rec[label] = recs
    for r, o in enumerate(outs):
        z, p = o["train"]["zero"], o["train"]["replicated"]
        check(z["bit_equal_to_replicated"],
              f"12e rank {r}: ZeRO params differ from replicated")
        check(0.45 <= z["moment_gb"] / p["moment_gb"] <= 0.55,
              f"12e rank {r}: moments {z['moment_gb']} / {p['moment_gb']}")
    return rec


def mesh_phase(world, phase12, tmp, sz=P12):
    """Phase 12: the mesh on one card. Two gloo ranks share the card (NCCL
    refuses two ranks on one device), each a process of its own
    (mesh_rank), under a timeout: a rank that fails or hangs fails the
    phase. Every rank's results must be equal (for TP: the two model
    ranks' picks) and each rank's timed search must launch what
    decode_launches counts. Against this process's runs on the same
    inputs: (a) DP at the int4 bar (top beam equal, each query's code sets
    differing by at most one, live scores within rtol 0.05 / atol 0.25);
    (b) TP in f32 on an exact cache at the int4 bar against the plain
    one-process f32 search on the same cache; TP in bf16 at the int4 bar against a one-process search that
    takes the same partial sums (parallel/reference.py::split_sums), its
    live beams on their trie groups, and its movement from the plain
    one-process search reported: at random bf16 weights the order of the
    sums alone moves the search past that bar; TP at TOY_TP's geometry at
    tests/test_sharded_decode.py's bars; (c) the engine's docids at the
    int4 bar, dense_topk's top-k sets equal apart from ties; (d) and (e)
    by check_mesh_serving and check_mesh_training ((e) reads phase 8's
    trainset in ``tmp``). Adds the ranks' launches to
    ``phase12``. The wall times of two ranks sharing one card say nothing
    of a run on two cards."""
    import os
    import pickle

    import torch
    from ripor_tpu_torch.data.tokenizer import tokenize_queries
    from ripor_tpu_torch.decode.beam import make_beam_search_fn
    from ripor_tpu_torch.evaluation.retriever import dense_topk
    from ripor_tpu_torch.models import RiporModel, init_params, ripor_base
    from ripor_tpu_torch.parallel import split_sums
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import succinct_tables, tables_to_torch

    t_phase = time.monotonic()
    dev, Bq, cfg = sz["device"], sz["batch"], world["cfg"]
    ids, mask = tokenize_queries(world["tok"], world["queries"][:Bq], 64)
    # the plain one-process f32 search on an exact cache (~38 GB at its
    # peak), before the ranks take the card's memory
    model32 = RiporModel(cfg, dtype=torch.float32, device=dev)
    model32.load_state_dict(world["sd"])
    ref32 = tuple(a.cpu().numpy() for a in make_beam_search_fn(
        cfg, sz["beam"], dtype=torch.float32, device=dev)(
            model32, ids, mask,
            tables_to_torch(succinct_tables(world["trie"]), dev)))
    del model32
    if dev == "cuda":
        torch.cuda.empty_cache()
    toy = toy_world()
    root = os.path.join(tmp, "mesh12")
    os.makedirs(root)
    # (e): phase 8's batches and float32 params from the seed
    train_cfg = sz["train_cfg"] or ripor_base(M=M, K=K)
    train = train_batches(world, tmp)[:5]
    sd32 = init_params(train_cfg, torch.Generator().manual_seed(SEED),
                       device="cpu")
    torch.save(sd32, os.path.join(root, "train_sd.pt"))
    with open(os.path.join(root, "world.pkl"), "wb") as f:
        pickle.dump({"sz": sz, "cfg": cfg, "trie": world["trie"],
                     "sd": {k: v.cpu() for k, v in world["sd"].items()},
                     "tok": world["tok"], "docids": world["docids"],
                     "queries": world["queries"], "toy": toy,
                     "train": train, "train_cfg": train_cfg}, f)
    logs = [open(os.path.join(root, f"rank{r}.log"), "wb") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
         "2", root], stdout=logs[r], stderr=subprocess.STDOUT)
        for r in (0, 1)]
    try:
        # the one-process references, while the ranks start
        eng = RetrievalEngine(
            cfg, world["sd"], world["tok"], world["trie"], world["docids"],
            ServeConfig(num_beams=sz["beam"], topk=sz["beam"],
                        batch_sizes=(Bq,), kv_cache_quant=sz["quant"]),
            device=dev)

        def search():
            return tuple(a.cpu().numpy() for a in eng._fn(
                eng._model, ids, mask, eng._tables))
        sync(dev)
        t0 = time.monotonic()
        ref = search()
        single_s = time.monotonic() - t0
        with split_sums(eng._model):
            floor = search()
        ref_engine = eng.retrieve_batch(world["queries"][:Bq])
        del eng
        tcfg, tsd, tids, tmask, ttrie = toy
        tmodel = RiporModel(tcfg, dtype=torch.float32, device=dev)
        tmodel.load_state_dict(tsd)
        ttables = tables_to_torch(succinct_tables(ttrie), dev)
        toy_ref = {name: tuple(a.cpu().numpy() for a in make_beam_search_fn(
            tcfg, 5, dtype=torch.float32, device=dev, **kw)(
                tmodel, tids, tmask, ttables))
            for name, (kw, *_) in TOY_TP.items()}
        q, corpus = dense_inputs(sz)
        ref_dense = dense_topk(q, corpus, sz["dense_k"])
        del corpus
        if dev == "cuda":
            torch.cuda.empty_cache()
        ref_train = train_reference(train_cfg, train[0], sd32, dev)
        del sd32
        deadline = time.monotonic() + sz["timeout"]
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(root, f"rank{r}.log")) as f:
                print(f.read()[-4000:], file=sys.stderr)
            check(False, f"12: rank {r} exited {p.returncode}")
    outs = []
    for r in (0, 1):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))

    searches = ("dp", "tp", "tp_f32")
    parts = [*searches] + [f"toy_{n}" for n in TOY_TP]
    for r, o in enumerate(outs):
        for part in parts:
            res = o[part]["res"] if part in searches else o[part]
            want = (outs[0][part]["res"] if part in searches
                    else outs[0][part])
            check(all(np.array_equal(a, b) for a, b in zip(res, want)),
                  f"12 {part}: rank {r}'s results differ from rank 0's")
    want = decode_launches(cfg.t5.num_decoder_layers, cfg.M, 1)
    rec = {"single_s": single_s, "single_ms_per_step": single_s / cfg.M * 1e3,
           "split_sums_floor": beam_agreement(ref, floor)}
    for part in searches:
        for r, o in enumerate(outs):
            check(o[part]["launches"] == want,
                  f"12 {part} rank {r}: launches {o[part]['launches']}, "
                  f"not {want}")
            for k, n in o[part]["launches"].items():
                phase12[k] = phase12.get(k, 0) + n
        res = outs[0][part]["res"]
        if dev == "cuda":
            check_beams(f"12 {part}", world["trie"], *res)
        agree = beam_agreement(ref32 if part == "tp_f32" else ref, res)
        rec[part] = {"s": [o[part]["s"] for o in outs],
                     "ms_per_step": [o[part]["ms_per_step"] for o in outs],
                     "launches_per_rank": outs[0][part]["launches"],
                     "against_one_process": agree}
    rec["all_reduce_ms"] = [o["all_reduce_ms"] for o in outs]
    rec["all_reduces_per_step"] = outs[0]["all_reduces_per_step"]
    rec["tp"]["against_split_sums"] = beam_agreement(floor,
                                                     outs[0]["tp"]["res"])
    for tag, agree in (("dp", rec["dp"]["against_one_process"]),
                       ("tp", rec["tp"]["against_split_sums"]),
                       ("tp_f32", rec["tp_f32"]["against_one_process"])):
        check(all(agree["top_beam_equal"])
              and max(agree["code_set_diff"]) <= 1
              and agree["max_diff_over_bar"] <= 1.0,
              f"12 {tag}: outside the int4 bar {agree}")
    for name, (_, rtol, atol, states) in TOY_TP.items():
        (s1, c1, st1), (s0, c0, st0) = outs[0][f"toy_{name}"], toy_ref[name]
        live = s0 > -1e29
        err = float(np.abs(s1[live] - s0[live]).max())
        check(np.array_equal(live, s1 > -1e29)
              and np.allclose(s1[live], s0[live], rtol=rtol, atol=atol)
              and live_equal(c1, c0, live)
              and (not states or live_equal(st1, st0, live)),
              f"12 toy TP {name}: max abs score diff {err}")
        rec[f"toy_tp_{name}_max_abs_err"] = err
    for r, o in enumerate(outs):
        check(o["engine"] == outs[0]["engine"],
              f"12 engine: rank {r}'s results differ from rank 0's")
        check(all(np.array_equal(a, b) for a, b in zip(
            o["dense"], outs[0]["dense"])),
            f"12 dense: rank {r}'s top-k differs from rank 0's")
    diff = check_engine_bar("12 engine", outs[0]["engine"], ref_engine)
    ok, worst = topk_sets_agree(*outs[0]["dense"], *ref_dense)
    check(ok, f"12 dense: top-k sets (worst rel score diff {worst})")
    rec.update(engine_docid_set_diff=diff, dense_worst_rel_diff=worst,
               dense_s=[o["dense_s"] for o in outs])
    rec["serving"] = check_mesh_serving(outs, ref_engine, cfg, phase12)
    rec["training"] = check_mesh_training(outs, ref_train, root)
    rec["seconds"] = time.monotonic() - t_phase
    print("mesh", json.dumps(rec))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from ripor_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run it from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          torch.cuda.get_device_name(0))
    t_all = time.monotonic()

    t0 = time.monotonic()
    _build.build_all()
    print("build", json.dumps({"seconds": time.monotonic() - t0,
                               **_build.BUILD_INFO}))
    for rec in ptxas_report(_build.BUILD_INFO["dir"], STAGED_KERNELS):
        print("ptxas", json.dumps(rec))

    results = []
    g = torch.Generator(device="cuda").manual_seed(SEED)
    phase_s = {}        # seconds of each part of phases 2 to 6b

    def timed(part, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        phase_s[part] = time.monotonic() - t0
        return out
    timed("2 megarow_checks", megarow_checks, results, g)
    timed("2 dataflow_checks", dataflow_checks, results, g)
    timed("2 deferred_checks", deferred_checks, results, g)
    timed("2 non_deferred_checks", non_deferred_checks, results, g)
    timed("2 write_attend_checks", write_attend_checks, results, g)
    timed("2 oversized_checks", oversized_checks, results, g)
    timed("2 tp_width_checks", tp_width_checks, results, g)
    timed("2 path_shape_checks P11", path_shape_checks, results, g,
          "phase 11", pipeline_searches(P11))
    timed("2 path_shape_checks P12", path_shape_checks, results, g,
          "phase 12", mesh_searches(P12))
    timed("3 small_agreement", small_agreement)
    world = timed("4 make_world", make_world)
    launches = {}
    timed("4 main_path", main_path, world, launches)
    phase6 = {}
    timed("5-6 other_paths", other_paths, world, phase6)
    phase6b = {}
    timed("6b dataflow_paths", dataflow_paths, world, phase6b)
    print("phase_s", json.dumps(phase_s))
    cli_launches = {}
    with tempfile.TemporaryDirectory(prefix="ripor_ws_") as tmp:
        cli_phase(world, cli_launches, tmp)
        train_phase(world, tmp)
        phase9 = {}
        docid_phase(world, phase9, tmp)
        teacher_phase(world, tmp)
        phase11 = {}
        pipeline_phase(world, phase11, tmp)
        phase12 = {}
        mesh_phase(world, phase12, tmp)

    # kernel: (TPU kernel it replaces, case of the reported times, path
    # whose run gives the launches)
    kernels_of = {
        "reorder_cache_all": ("ripor_tpu/ops/megarow.py:288", "int4 Mc=32",
                              launches),
        "step_attention_seq": ("ripor_tpu/ops/megarow.py:666", "int4 Mc=32",
                               launches),
        "beam_gather_rows": ("ripor_tpu/ops/beam_gather.py:47", "int4 Mc=32",
                             launches),
        "step_attend_reorder": ("ripor_tpu/ops/attend_reorder.py:525",
                                "int4 Mc=32", phase6),
        "step_attention_fused": ("ripor_tpu/ops/step_attention.py:165",
                                 "bf16 Mc=32", phase6),
        "beam_gather_update": ("ripor_tpu/ops/beam_gather.py:181",
                               "bf16 Mc=32", phase6),
        "step_attention": ("ripor_tpu/ops/step_attention.py:67",
                           "bf16 Mc=32 t=31", phase6),
        "beam_gather_blocks": ("ripor_tpu/ops/beam_gather.py:93",
                               "bf16 Mc=32", phase6),
        # the bodies of the megarow dataflows (phase 6b)
        "reorder_cache_all_qinsert": ("ripor_tpu/ops/megarow.py:149",
                                      "int4 Mc=32 t=16", phase6b),
        "reorder_cache_all_fused": ("ripor_tpu/ops/megarow.py:161",
                                    "int4 rows Mc=32", phase6b),
        "step_attention_seq_mxu": ("ripor_tpu/ops/megarow.py:483",
                                   "int4 Mc=32", phase6b),
    }
    source = {"reorder_cache_all_qinsert": "reorder_cache_all",
              "reorder_cache_all_fused": "reorder_cache_all",
              "step_attention_seq_mxu": "step_attention_seq"}
    kernels = []
    for name, (replaces, case, counts) in kernels_of.items():
        recs = [r for n, _, r in results if n == name]
        main = next(r for n, tg, r in results if n == name and tg == case)
        check(counts[name] > 0, f"kernel {name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ripor_tpu_torch/csrc/{source.get(name, name)}.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "case": case,
            "launches_rq_trie": phase9.get(name, 0),
            "launches_pipeline": phase11.get(name, 0),
            "launches_mesh": phase12.get(name, 0)})
    print("total_s", time.monotonic() - t_all)
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
