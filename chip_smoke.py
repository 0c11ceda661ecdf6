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
     rows; K4 with int4, int8 (exact and pre-quantized kvg rows) and bf16
     rows; K5 in bf16 (and f32 at Mc=32) and K6 in bf16; K8 in bf16 and
     f32 at two slots t; K7 in bf16, int8 and on narrow blocks; then the
     slabs no stage holds (slot chunks, one layer): K2 and K4 at t5-3b
     widths in bf16 and int8 rows and at t5-large in f32, K5 and K8 at
     t5-large in f32 and t5-3b in bf16. Time kernel, plain version and
     one PyTorch call of the same function where there is one (advanced
     indexing for the gathers, scaled_dot_product_attention for K5 and
     K8): a yardstick the port never uses;
  3. agreement on a small input: the port's beam search through the
     kernels on the card against its plain path on the CPU (the path the
     CPU tests hold against the JAX package), on the megarow and deferred
     paths (exact, int8, int4 caches), the non-deferred path and the
     write-then-attend path;
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
     phase 5;
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
     checkpoint ``retrieve`` then serves with phase 7's checks.

Prints the card's name and power limit (nvidia-smi), per-phase lines, then
a ``{"kernels": [...]}`` line and, last, the contract line
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
    from ripor_tpu_torch.ops import (beam_gather_rows,
                                     beam_gather_rows_plain,
                                     reorder_cache_all,
                                     reorder_cache_all_plain)
    bidx = torch.arange(B, device="cuda")[:, None]
    for Mc in SEGMENTS:
        for quant in ("int4", "int8", None):
            tag = f"{quant or 'bf16'} Mc={Mc}"
            cache = random_rows(quant, (B, N, L, Mc), g)
            RW = cache.shape[-1]
            src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                                dtype=torch.int32)
            uniq = unique_sources(src)
            slab = L * Mc * RW * cache.element_size()
            t = Mc - 1
            n_before = len(results)
            ends = Mc in (SEGMENTS[0], SEGMENTS[-1])  # K1 and K3 only there

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

            step_attention_seq_case(results, tag, quant, cache, Mc, t, g)
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
            torch.cuda.empty_cache()
            print_checks(results[n_before:])


def print_checks(recs):
    for name, tg, r in recs:
        print("kernel_check", json.dumps({"kernel": name, "case": tg, **r}))


def step_attention_seq_case(results, tag, quant, cache, Mc, t, g, layer=5,
                            width=(F, H), tol=2e-2):
    """K2 at ``layer`` of a [B, N, L, Mc, RW] cache against its plain
    version, with the QFUSE rows for quantized caches (bit-equal)."""
    import torch
    from ripor_tpu_torch.ops import (step_attention_seq,
                                     step_attention_seq_plain)
    from ripor_tpu_torch.ops.staging import stage_plan
    F, H = width
    RW = cache.shape[-1]
    q, kv_new, bias_hist, bias_new = attention_inputs(
        Mc, t, g, width, torch.float32 if cache.dtype == torch.float32
        else None)
    args = (q, kv_new, cache, layer, bias_hist, bias_new, H, quant)
    got = step_attention_seq(*args)
    want = step_attention_seq_plain(*args)
    torch.cuda.synchronize()
    if quant:
        (got, got_q), (want, want_q) = got, want
        check(torch.equal(got_q, want_q),
              f"step_attention_seq emit_quant rows {tag}")
    err = (got.float() - want.float()).abs().max().item()
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
          f"step_attention_seq {tag}: max abs err {err}")
    plan = stage_plan(quant, cache.element_size(), q.element_size(), Mc, F, H)
    rec = dict(ms=cuda_ms(lambda: step_attention_seq(*args), 20),
               plain_ms=cuda_ms(lambda: step_attention_seq_plain(*args), 3),
               library_ms=None, max_abs_err=err, stages=plan.stages,
               chunk_slots=plan.chunk_slots, smem_bytes=plan.smem_bytes)
    outs = nbytes(got) + (B * N * RW if quant else 0)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes(q, kv_new, bias_hist, bias_new) + outs
        + B * N * Mc * RW * cache.element_size(), 4.0 * B * N * (Mc + 1) * F)
    results.append(("step_attention_seq", tag, rec))


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
    from ripor_tpu_torch.ops import (beam_gather_update,
                                     beam_gather_update_plain)
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

        G = L * 2 * B
        flat = cache.view(G, N, Mc, F)
        src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                            dtype=torch.int32)
        src_rep = src.repeat(L * 2, 1)
        kvg = torch.randn(G, N, F, generator=g, device="cuda",
                          dtype=torch.bfloat16)
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
        slab = Mc * F * flat.element_size()
        rec["bound_ms"], rec["bound_by"] = bound(
            L * 2 * unique_sources(src) * slab + G * N * slab
            + nbytes(kvg, src_rep))
        results.append(("beam_gather_update", tag, rec))
        print("kernel_check", json.dumps({"kernel": "beam_gather_update",
                                          "case": tag, **rec}))
        del cache, flat, out, kvg
        torch.cuda.empty_cache()


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
    from ripor_tpu_torch.ops import (beam_gather_blocks,
                                     beam_gather_blocks_plain)
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

    G = L * 2 * B
    for dtype, Mc, C in ((torch.bfloat16, 8, F), (torch.bfloat16, 32, F),
                         (torch.int8, 32, F), (torch.int8, 3, 13)):
        tag = (f"{'bf16' if dtype == torch.bfloat16 else 'int8'} Mc={Mc}"
               + ("" if C == F else f" C={C}"))
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
        del cache, out
        torch.cuda.empty_cache()


SMALL_RUNS = (                   # (path, make_beam_search_fn kwargs)
    ("megarow", dict(kv_cache_quant=None)),
    ("megarow", dict(kv_cache_quant="int8")),
    ("megarow", dict(kv_cache_quant="int4")),
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
    out = {}
    for dev in ("cpu", "cuda"):
        model = RiporModel(cfg, device=dev)
        model.load_state_dict(sd)
        for i, (_, kw) in enumerate(SMALL_RUNS):
            fn = make_beam_search_fn(cfg, 16, dtype=torch.float32,
                                     device=dev, **kw)
            out[dev, i] = [a.cpu().numpy() for a in fn(
                model, ids, mask, tables_to_torch(tables, dev))]
    for i, (path, kw) in enumerate(SMALL_RUNS):
        (s0, c0, st0), (s1, c1, st1) = out["cpu", i], out["cuda", i]
        quant = kw.get("kv_cache_quant")
        kvg = " kvg int8" if kw.get("kvg_quant_xla") else ""
        tag = f"{path} {quant or 'f32'}{kvg}"
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
            "top_beam_equal": True,
            "max_abs_score_diff": float(np.abs(s0 - s1).max())}))


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
    from ripor_tpu_torch.ops import KERNEL_LAUNCHES
    from ripor_tpu_torch.pipeline import load_tokenizer
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig, serve_http
    from ripor_tpu_torch.train import load_params, save_params

    cfg, trie, docids = world["cfg"], world["trie"], world["docids"]
    dev = world["device"]
    texts = world["queries"][:16]
    qids = [f"q{i}" for i in range(16)]

    def zero():
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0

    def need(tag, kernels):
        counts = dict(KERNEL_LAUNCHES)
        for k in kernels:
            check(counts[k] > 0, f"{tag}: kernel {k} never launched")
        return counts

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

    zero()
    out = run_cli(base, "in process")
    counts = need("cli retrieve", MEGAROW_KERNELS)
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
    zero()
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
    counts = need("serve", MEGAROW_KERNELS)
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
    from ripor_tpu_torch.data.collators import (MarginMSECollator,
                                                batches_from_teacher_examples)
    from ripor_tpu_torch.data.datasets import (Collection,
                                               TeacherScoreExamples)
    from ripor_tpu_torch.models import RiporModel, init_params, ripor_base
    from ripor_tpu_torch.pipeline import load_tokenizer
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
    queries = Collection(qdir)
    trainset = os.path.join(tmp, "train.jsonl")
    write_trainset(trainset, queries.ids, 10 * TRAIN_B, rng)
    examples = TeacherScoreExamples(trainset)
    check(examples.prefix_lengths_present() == TRAIN_PREFIXES,
          "8b: prefix scores missing")
    coll = MarginMSECollator(
        load_tokenizer(os.path.join(ws, "tokenizer.json")), queries,
        dict(zip(world["docids"], codes)), max_length=TRAIN_LQ,
        prefix_lengths=TRAIN_PREFIXES)
    batches = list(batches_from_teacher_examples(examples, coll, TRAIN_B,
                                                 seed=SEED))
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
    megarow_checks(results, g)
    deferred_checks(results, g)
    non_deferred_checks(results, g)
    write_attend_checks(results, g)
    oversized_checks(results, g)
    small_agreement()
    world = make_world()
    launches = {}
    main_path(world, launches)
    phase6 = {}
    other_paths(world, phase6)
    cli_launches = {}
    with tempfile.TemporaryDirectory(prefix="ripor_ws_") as tmp:
        cli_phase(world, cli_launches, tmp)
        train_phase(world, tmp)

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
    }
    kernels = []
    for name, (replaces, case, counts) in kernels_of.items():
        recs = [r for n, _, r in results if n == name]
        main = next(r for n, tg, r in results if n == name and tg == case)
        check(counts[name] > 0, f"kernel {name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ripor_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "case": case})
    print("total_s", time.monotonic() - t_all)
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
