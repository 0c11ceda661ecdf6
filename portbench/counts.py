"""Operations and bytes from shapes, and the chip's peaks: the yardstick
of the per-layer metrics.

The bytes of the two megarow kernels count each input byte once and each
output byte once (a cache slab of a beam that several beams copy is read
once); the model's operations count what the searches need: the tokens
each query has (not its padding) and the beams alive at each step (not
the dead ones a fixed-shape search still computes).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    """The least time of a kernel: bytes over the HBM rate or float32
    operations over the CUDA cores' rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def k1_bytes(B: int, N: int, L: int, Mc: int, RW: int, unique_src: int,
             kvg_row: int) -> int:
    """reorder_cache_all: every beam's slab (L * Mc rows of RW bytes)
    written, each distinct source slab read once, this step's rows (L a
    beam, ``kvg_row`` bytes each) and the int32 sources read."""
    slab = L * Mc * RW
    return unique_src * slab + B * N * slab + B * N * L * kvg_row + B * N * 4


def k2_bytes(B: int, N: int, F: int, H: int, Mc: int, RW: int,
             act_bytes: int, emit: bool) -> int:
    """step_attention_seq, one layer: the beams' slabs of that layer (Mc
    rows of RW bytes), q and this position's K|V rows, the float32 biases,
    the output and, with QFUSE, the emitted cache rows."""
    return (B * N * Mc * RW + B * N * 3 * F * act_bytes
            + (Mc + 1) * H * 4 + B * N * F * act_bytes
            + (B * N * RW if emit else 0))


def k2_flops(B: int, N: int, F: int, Mc: int) -> float:
    return 4.0 * B * N * (Mc + 1) * F


def live_beams(codes: np.ndarray, K: int, N: int, M: int) -> List[int]:
    """Beams alive at each of the M steps of a trie-constrained search of
    N beams over the corpus ``codes`` [docs, M]: step t extends every
    distinct prefix of t codes until there are N of them."""
    P = [1]
    key = np.zeros(len(codes), np.int64)
    bits = max(1, int(K - 1).bit_length())
    for t in range(1, M):
        if P[-1] >= N:
            break
        if t * bits > 62:
            order = np.lexsort(codes[:, :t].T[::-1])
            s = codes[order, :t]
            P.append(1 + int(np.any(s[1:] != s[:-1], axis=1).sum()))
            continue
        key = key * K + codes[:, t - 1].astype(np.int64)
        P.append(int(np.unique(key).size))
    P += [N] * (M - len(P))
    return [min(N, p) for p in P]


def encoder_flops(d: dict, S: int) -> float:
    inner = d["num_heads"] * d["d_kv"]
    per = (2.0 * S * d["d_model"] * 4 * inner + 4.0 * S * S * inner
           + 4.0 * S * d["d_model"] * d["d_ff"])
    return per * d["num_layers"]


def beam_step_flops(d: dict, t: int, S: int) -> float:
    """One beam at decode position t over an S-token query: self-attention
    projections and its t + 1 positions, cross-attention's q and output
    projections over S positions, the FFN, and the codebook head over
    all K codes."""
    inner = d["num_heads"] * d["d_kv"]
    dm = d["d_model"]
    per_layer = (2.0 * dm * 4 * inner + 4.0 * (t + 1) * inner
                 + 2.0 * dm * 2 * inner + 4.0 * S * inner
                 + 4.0 * dm * d["d_ff"])
    return per_layer * d["num_decoder_layers"] + 2.0 * dm * d["K"]


def search_flops(d: dict, S: int, live: Sequence[int]) -> float:
    """Model operations one query of S tokens needs: the encoder, the
    cross-attention keys and values, and every live beam of every step."""
    inner = d["num_heads"] * d["d_kv"]
    cross = 4.0 * S * d["d_model"] * inner * d["num_decoder_layers"]
    return (encoder_flops(d, S) + cross
            + sum(n * beam_step_flops(d, t, S) for t, n in enumerate(live)))


def mfu_percent(flops: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS


def share_percent(bound: float, measured: float) -> Optional[float]:
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def search_launches(L: int, M: int) -> Dict[str, int]:
    """Launches one megarow search of M steps over an L-layer decoder
    makes: K1 once a step, K2 once a layer a step, K3 once a step but the
    last."""
    return {"reorder_cache_all": M, "step_attention_seq": M * L,
            "beam_gather_rows": M - 1}
