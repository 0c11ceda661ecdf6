#!/usr/bin/env python3
"""Time K2 and K4 at t5-base shapes under ring depths 1, 2 and 3.

    python3 chip_stage_bench.py

Needs one CUDA card. For each stage cap it sets ``ops.staging.MAX_STAGES``
(the launch plan then picks at most that many stages) and times K2
(``step_attention_seq``) and K4 (``step_attend_reorder``) at B=8, N=1000,
t5-base widths with CUDA events, after a check against the plain version
(within 2e-2). Two rounds over the caps; prints one line per case and cap
with both rounds' (ms, agreed) and the plan's (stages, shared bytes).
The measurements behind ``ops/staging.py``'s choice of depth.
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
                                     step_attention_seq,
                                     step_attention_seq_plain)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    B, N, F, H = cs.B, cs.N, cs.F, cs.H
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cases = []                  # (name, run, want, plan args)
    for quant, Mc in (("int4", 8), ("int4", 32), ("int8", 32), (None, 32)):
        cache = cs.random_rows(quant, (B, N, 2, Mc), g)
        q, kv_new, bh, bn = cs.attention_inputs(Mc, Mc - 1, g)
        args = (q, kv_new, cache, 1, bh, bn, H, quant)
        want = step_attention_seq_plain(*args)
        cases.append((f"K2 {quant or 'bf16'} Mc={Mc}",
                      lambda a=args: step_attention_seq(*a),
                      want[0] if quant else want,
                      (quant, cache.element_size(), 2, Mc, F, H, False)))
    for quant, kvg_q8, Mc in (("int4", False, 8), ("int4", False, 32),
                              ("int8", True, 32), (None, False, 32)):
        cache = cs.random_rows(quant, (2, B, N, Mc), g)
        src = torch.randint(0, N, (B, N), generator=g, device="cuda",
                            dtype=torch.int32)
        kvg = cs.random_rows("int8" if kvg_q8 else None, (B, N, 2),
                             g).reshape(B, N, -1)
        q, kv_new, bh, bn = cs.attention_inputs(Mc, Mc - 1, g)
        args = (q, kv_new, kvg, cache, torch.empty_like(cache), src, 1,
                Mc - 1, bh, bn, H)
        want = step_attend_reorder_plain(*args[:4], torch.empty_like(cache),
                                         *args[5:])[0]
        cases.append((f"K4 {quant or 'bf16'}{' kvg int8' if kvg_q8 else ''}"
                      f" Mc={Mc}", lambda a=args: step_attend_reorder(*a)[0],
                      want, (quant, cache.element_size(), 2, Mc, F, H,
                             quant is not None and not kvg_q8)))
    out = {}
    for _ in range(2):
        for cap in (1, 2, 3):
            staging.MAX_STAGES = cap
            for name, run, want, plan_args in cases:
                got = run()
                if isinstance(got, tuple):
                    got = got[0]
                ok = torch.allclose(got.float(), want.float(), rtol=2e-2,
                                    atol=2e-2)
                plan = staging.stage_plan(*plan_args[:6],
                                          exact_kvg=plan_args[6])
                rec = out.setdefault(f"{name} cap={cap}", {
                    "stages": plan.stages, "smem_bytes": plan.smem_bytes,
                    "runs": []})
                rec["runs"].append((cs.cuda_ms(run, 20), ok))
    for k, v in out.items():
        print(k, json.dumps(v))
    return 0 if all(ok for v in out.values() for _, ok in v["runs"]) else 1


if __name__ == "__main__":
    sys.exit(main())
