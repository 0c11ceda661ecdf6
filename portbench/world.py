"""What a run is made of, all from its seed: the weights (on the device),
the corpus's codes and their trie, the queries, and the engine under test.

Every seed gets the same sizes: the same number of weights, documents and
queries, and the same multiset of query lengths, drawn in another order.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def _seed(seed: int) -> int:
    return int(seed) % (1 << 63)


def weight_std(name: str, d: dict) -> float:
    """The standard deviation T5's initializers give each weight (ones for
    the norms' scales are not drawn): q by (d_model * d_kv)^-1/2, k, v and
    the FFN's input by d_model^-1/2, the attention output by the inner
    width's, the FFN's output by d_ff's, and 1 for the embeddings, the
    relative-position tables, the codebooks and the start embedding."""
    leaf = name.split(".")[-2] if name.endswith(".weight") else None
    inner = d["num_heads"] * d["d_kv"]
    return {"q": (d["d_model"] * d["d_kv"]) ** -0.5,
            "k": d["d_model"] ** -0.5, "v": d["d_model"] ** -0.5,
            "wi": d["d_model"] ** -0.5, "o": inner ** -0.5,
            "wo": d["d_ff"] ** -0.5}.get(leaf, 1.0)


def program_config(d: dict):
    from ripor_tpu_torch.models.config import RiporConfig, T5Config
    t5 = T5Config(**{k: d[k] for k in (
        "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
        "num_decoder_layers", "num_heads", "relative_attention_num_buckets",
        "relative_attention_max_distance", "layer_norm_epsilon",
        "feed_forward_proj")}, dropout_rate=0.0)
    return RiporConfig(t5=t5, M=d["M"], K=d["K"])


def make_weights(cfg, d: dict, seed: int, device, dtype) -> Dict[str, object]:
    """The model's weights by name, drawn on ``device`` from the seed in
    one call of ``dtype`` and scaled per weight; the norms' scales are
    float32 ones."""
    import torch
    from ripor_tpu_torch.models.ripor import RiporModel
    shapes = {k: tuple(v.shape) for k, v in
              RiporModel(cfg, device="meta").state_dict().items()}
    drawn = [k for k in shapes if not k.endswith(".scale")]
    sizes = [math.prod(shapes[k]) for k in drawn]
    g = torch.Generator(device=device).manual_seed(_seed(seed))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    out = {}
    for k, part in zip(drawn, flat.split(sizes)):
        out[k] = part.view(shapes[k]).mul_(weight_std(k, d))
    for k in shapes:
        if k.endswith(".scale"):
            out[k] = torch.ones(shapes[k], dtype=torch.float32, device=device)
    return out


def make_codes(corpus: dict, d: dict, seed: int) -> np.ndarray:
    """[docs, M] int32 codes shaped like residual quantization's: the
    first ``narrow_levels`` positions drawn from a quarter of the
    codebook (shared prefixes), the rest from all K codes."""
    rng = np.random.default_rng([_seed(seed), 1])
    n, M, K = corpus["docs"], d["M"], d["K"]
    narrow = corpus["narrow_levels"]
    codes = np.empty((n, M), np.int32)
    codes[:, :narrow] = rng.integers(0, max(2, K // 4), (n, narrow),
                                     dtype=np.int32)
    codes[:, narrow:] = rng.integers(0, K, (n, M - narrow), dtype=np.int32)
    return codes


def make_queries(spec: dict, seed: int, count: int) -> List[str]:
    """``count`` queries of ``spec["words"] = [lo, hi]`` words, every
    length from lo to hi equally often, words drawn uniformly from a
    vocabulary of ``spec["vocabulary"]``."""
    rng = np.random.default_rng([_seed(seed), 2])
    lo, hi = spec["words"]
    lengths = np.resize(np.arange(lo, hi + 1), count)
    rng.shuffle(lengths)
    words = rng.integers(0, spec["vocabulary"], int(lengths.sum()))
    out, at = [], 0
    for n in lengths:
        out.append(" ".join(f"w{j}" for j in words[at:at + n]))
        at += n
    return out


def make_engine(cfg, weights, codes: np.ndarray, engine: dict, device):
    """The system under test: the trie of the codes, built as an index
    load builds it, and a RetrievalEngine over it, warmed on the cell's
    batch sizes."""
    from ripor_tpu_torch.data.tokenizer import HashTokenizer
    from ripor_tpu_torch.serve import RetrievalEngine, ServeConfig
    from ripor_tpu_torch.trie import build_trie
    trie = build_trie(codes, cfg.K)
    scfg = ServeConfig(num_beams=engine["num_beams"], topk=engine["topk"],
                       max_length=engine["max_length"],
                       batch_sizes=tuple(engine["batch_sizes"]),
                       kv_cache_quant=engine["kv_cache_quant"],
                       max_delay_ms=engine["max_delay_ms"])
    return RetrievalEngine(cfg, weights, HashTokenizer(cfg.t5.vocab_size),
                           trie, list(map(str, range(len(codes)))), scfg,
                           device=device)
