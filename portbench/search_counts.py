"""Bytes and operations of a decode step's select and codebook head,
counted from shapes as the work needs them, whatever implements it: the
yardstick of select_roofline.offline and codebook_head_roofline.offline.
(The peaks are counts.py's.)"""
from __future__ import annotations

from typing import Tuple

from portbench.counts import HBM_BYTES_PER_S, PEAK_BF16_FLOPS


def select_bytes(B: int, N: int, K: int, M: int) -> int:
    """One step's select over B queries of N beams and K codes: each
    beam's logits read once as float32 (4K), its trie bitmask row as
    32-bit words (4 ceil(K/32)), its M codes read and written in the
    reorder at 4 bytes (8M), its score and state read and its score,
    source, token and state written at 4 bytes each (24)."""
    return B * N * (4 * K + 4 * -(-K // 32) + 8 * M + 24)


def head_work(B: int, N: int, d: int, K: int) -> Tuple[float, int]:
    """(operations, bytes) of one step's head over the codebook: B*N
    hidden states of width d against the position's book [K, d], 2*d*K
    operations a beam; the hidden states and the book read in bfloat16,
    the logits written in float32."""
    return 2.0 * B * N * d * K, 2 * B * N * d + 2 * K * d + 4 * B * N * K


def head_bound_s(flops: float, nbytes: float) -> float:
    """The head's least time: its bytes at the HBM rate or its operations
    at the bfloat16 tensor-core peak, whichever is larger (bfloat16
    products are exact in float32, so a head on the tensor cores is held
    to the same bound)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
