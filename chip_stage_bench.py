#!/usr/bin/env python3
"""Time the staged kernels K2, K4, K5 and K8 under ring depths 1, 2 and 3.

    python3 chip_stage_bench.py

Needs one CUDA card. For each stage cap it sets ``ops.staging.MAX_STAGES``
(the launch plan then picks at most that many stages) and times K2
(``step_attention_seq``), K4 (``step_attend_reorder``), K5
(``step_attention_fused``) and K8 (``step_attention``) at B=8, N=1000,
t5-base widths with CUDA events, after a check against the plain version
(f32 within 1e-4, else 2e-2); then one slab no stage holds per kernel
(slot chunks: t5-3b widths in bf16, K8 at t5-large in f32). Two rounds
over the caps; prints one line per case and cap with both rounds' (ms,
agreed) and the plan's (stages, slots a stage holds, shared bytes). The
measurements behind ``ops/staging.py``'s choice of depth.
"""
import json
import subprocess
import sys

import chip_smoke as cs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_stage_bench: no CUDA device", file=sys.stderr)
        return 1
    from ripor_tpu_torch.ops import (staging, step_attend_reorder,
                                     step_attend_reorder_plain,
                                     step_attention, step_attention_fused,
                                     step_attention_fused_plain,
                                     step_attention_plain,
                                     step_attention_seq,
                                     step_attention_seq_plain)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    B, N = cs.B, cs.N
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = []         # (name, run, want, tol, plan args, plan keywords)
    base, big, large = (cs.F, cs.H), cs.T5_3B, cs.T5_LARGE
    for quant, Mc, width in (("int4", 8, base), ("int4", 32, base),
                             ("int8", 32, base), (None, 32, base),
                             (None, 32, big)):
        F, H = width
        layers = 2 if width == base else 1      # one layer of a big slab
        cache = cs.random_rows(quant, (B, N, layers, Mc), g, width)
        q, kv_new, bh, bn = cs.attention_inputs(Mc, Mc - 1, g, width)
        args = (q, kv_new, cache, layers - 1, bh, bn, H, quant)
        want = step_attention_seq_plain(*args)
        cases.append((f"K2 {quant or 'bf16'} Mc={Mc} F={F}",
                      lambda a=args: step_attention_seq(*a),
                      want[0] if quant else want, 2e-2,
                      (quant, cache.element_size(), 2, Mc, F, H), {}))
    for quant, kvg_q8, Mc, width in (("int4", False, 8, base),
                                     ("int4", False, 32, base),
                                     ("int8", True, 32, base),
                                     (None, False, 32, base),
                                     (None, False, 32, big)):
        F, H = width
        layers = 2 if width == base else 1
        cache = cs.random_rows(quant, (layers, B, N, Mc), g, width)
        src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                            dtype=torch.int32)
        kvg = cs.random_rows("int8" if kvg_q8 else None, (B, N, layers), g,
                             width).reshape(B, N, -1)
        q, kv_new, bh, bn = cs.attention_inputs(Mc, Mc - 1, g, width)
        args = (q, kv_new, kvg, cache, torch.empty_like(cache), src,
                layers - 1, Mc - 1, bh, bn, H)
        want = step_attend_reorder_plain(*args[:4], torch.empty_like(cache),
                                         *args[5:])[0]
        cases.append((f"K4 {quant or 'bf16'}{' kvg int8' if kvg_q8 else ''}"
                      f" Mc={Mc} F={F}",
                      lambda a=args: step_attend_reorder(*a)[0], want, 2e-2,
                      (quant, cache.element_size(), 2, Mc, F, H),
                      dict(exact_kvg=quant is not None and not kvg_q8)))
    for kernel, dtype, Mc, width in (
            ("K5", torch.bfloat16, 8, base), ("K5", torch.bfloat16, 32, base),
            ("K5", torch.float32, 32, base), ("K5", torch.bfloat16, 32, big),
            ("K8", torch.bfloat16, 8, base), ("K8", torch.bfloat16, 32, base),
            ("K8", torch.float32, 32, base), ("K8", torch.float32, 32, large)):
        F, H = width
        kv = torch.randn(1, 2, B, N, Mc, F, generator=g, device="cuda",
                         dtype=dtype)
        q, kv_new, bh, bn = cs.attention_inputs(Mc, Mc - 1, g, width, dtype)
        if kernel == "K5":
            args = (q, kv_new[..., :F].contiguous(),
                    kv_new[..., F:].contiguous(), kv, 0, bh, bn, H)
            fn, plain = step_attention_fused, step_attention_fused_plain
        else:
            bh[Mc - 1:] = 0.0
            args = (q, kv[0, 0], kv[0, 1], bh, H)
            fn, plain = step_attention, step_attention_plain
        esz = kv.element_size()
        cases.append((f"{kernel} {'f32' if esz == 4 else 'bf16'} Mc={Mc} "
                      f"F={F}", lambda a=args, f=fn: f(*a), plain(*args),
                      1e-4 if esz == 4 else 2e-2, (None, esz, esz, Mc, F, H),
                      dict(planes=True, new=kernel == "K5")))
    out = {}
    for _ in range(2):
        for cap in (1, 2, 3):
            staging.MAX_STAGES = cap
            for name, run, want, tol, plan_args, plan_kw in cases:
                got = run()
                if isinstance(got, tuple):
                    got = got[0]
                ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                    atol=tol)
                plan = staging.stage_plan(*plan_args, **plan_kw)
                rec = out.setdefault(f"{name} cap={cap}", {
                    "stages": plan.stages, "chunk_slots": plan.chunk_slots,
                    "smem_bytes": plan.smem_bytes, "runs": []})
                rec["runs"].append((cs.cuda_ms(run, 20), ok))
    for k, v in out.items():
        print(k, json.dumps(v))
    return 0 if all(ok for v in out.values() for _, ok in v["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
