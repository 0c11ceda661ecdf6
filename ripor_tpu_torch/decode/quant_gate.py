"""Quantization-mode quality gate for production decode paths.

A copy of ripor_tpu/decode/quant_gate.py (the port imports no ripor_tpu
module), with one deliberate difference: the port reads no RIPOR_*
environment switch, so there is no environment override. An operator who
accepts an unvalidated combination records that decision next to the
checkpoint (``record_quant_validation(..., accepted=True)``).

The KV-cache quants (int8/int4) only perturb attention reads, and the JAX
package's validators found them retrieval-transparent. The int8-weight
FFN (ops/int8_ffn.py) perturbs the output logits, and its effect on the
ranking compounds with a quantized KV cache, so it is model-dependent:
the serving engine and stage_retrieve preflight
(``ensure_quant_validated``) refuse an ffn_int8 combination unless a
validation of this checkpoint is recorded and accepted in
``<ckpt_dir>/quant_validation.json`` (the same file and format the JAX
package reads and writes).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

VALIDATION_FILE = "quant_validation.json"
# below this fraction of order-identical queries the combo is recorded but
# still refused (the validator found real ranking movement; an operator can
# accept it explicitly with {"accepted": true})
ORDER_IDENTICAL_ACCEPT = 0.9


def quant_combo_key(kv_cache_quant: Optional[str], ffn_int8: bool) -> str:
    """Canonical name for a quant combination, e.g. "ffn_int8+int4kv"."""
    parts = []
    if ffn_int8:
        parts.append("ffn_int8")
    if kv_cache_quant:
        parts.append(f"{kv_cache_quant}kv")
    return "+".join(parts) or "exact"


def record_quant_validation(ckpt_dir, combo: str, n_queries: int,
                            set_identical: int, order_identical: int,
                            metrics_identical: bool,
                            accepted: Optional[bool] = None) -> Dict:
    """Write one validator verdict into ``<ckpt_dir>/quant_validation.json``
    (merging with existing combos). ``accepted`` defaults to the
    ORDER_IDENTICAL_ACCEPT threshold; validators (or operators reviewing
    their output) may force it either way."""
    path = Path(ckpt_dir) / VALIDATION_FILE
    data = json.loads(path.read_text()) if path.exists() else {}
    if accepted is None:
        accepted = (n_queries > 0
                    and order_identical / n_queries >= ORDER_IDENTICAL_ACCEPT)
    data[combo] = {
        "n_queries": int(n_queries),
        "set_identical": int(set_identical),
        "order_identical": int(order_identical),
        "metrics_identical": bool(metrics_identical),
        "accepted": bool(accepted),
    }
    path.write_text(json.dumps(data, indent=1))
    return data[combo]


def ensure_quant_validated(kv_cache_quant: Optional[str], ffn_int8: bool,
                           ckpt_dir=None) -> None:
    """Preflight for a production decode configuration.

    KV-only quants pass (see the module doc). ffn_int8 combos require a
    recorded, accepted validation for THIS checkpoint
    (``record_quant_validation``) and raise a ValueError otherwise.
    """
    if not ffn_int8:
        return
    combo = quant_combo_key(kv_cache_quant, ffn_int8)
    entry = None
    if ckpt_dir is not None:
        path = Path(ckpt_dir) / VALIDATION_FILE
        if path.exists():
            entry = json.loads(path.read_text()).get(combo)
    if entry is not None and entry.get("accepted"):
        return
    if entry is not None:
        why = (f"checkpoint validation for {combo!r} exists but was NOT "
               f"accepted ({entry.get('order_identical', '?')}/"
               f"{entry.get('n_queries', '?')} "
               f"order-identical vs the exact path)")
    elif ckpt_dir is None:
        why = (f"no checkpoint directory was provided, so the {combo!r} "
               "combination cannot be checked against a recorded validation")
    else:
        why = (f"no recorded validation for {combo!r} in "
               f"{Path(ckpt_dir) / VALIDATION_FILE}")
    raise ValueError(
        f"quant preflight: {why}. ffn_int8 perturbs output logits and its "
        "ranking impact is model-dependent — compare this checkpoint's "
        "ffn_int8 runs with the exact path and record the verdict with "
        "record_quant_validation (accepted=True records an operator's "
        "decision to proceed unvalidated).")
