"""Model configurations.

``T5Config`` describes the from-scratch T5 v1.0 encoder-decoder (the reference
fine-tunes HF ``t5-base``; see modeling/t5_generative_retriever.py:70 and its
T5Stack usage). ``RiporConfig`` adds the RIPOR DocID geometry: M per-position
vocabularies of K codes each (reference ``decoder_vocab_sizes=[256]*32``,
modeling/t5_generative_retriever.py:45-67).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 768
    d_kv: int = 64
    d_ff: int = 3072
    num_layers: int = 12           # encoder layers
    num_decoder_layers: int = 12
    num_heads: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    dropout_rate: float = 0.1
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # t5 v1.0 (t5-base); "gated-gelu" for v1.1
    pad_token_id: int = 0
    # rematerialize each encoder/decoder layer in the backward pass
    # (activation checkpointing): trades ~33% forward FLOPs for O(layers) less
    # activation HBM — lets train batches 2-4x larger per chip (the saved
    # attention scores OOM t5-base at batch 512 otherwise)
    remat_layers: bool = False
    # tensor-parallel axis name (megatron-style): when set, this config
    # describes the PER-DEVICE shard (num_heads and d_ff already divided by
    # the axis size) and attention/FFN output projections psum over the
    # axis. Only meaningful inside shard_map (decode TP for models whose
    # beam-1000 KV cache overflows one chip, e.g. t5-large; VERDICT r1 #6).
    tp_axis: "str | None" = None

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated-")


def t5_base() -> T5Config:
    return T5Config()


def t5_small() -> T5Config:
    return T5Config(d_model=512, d_ff=2048, num_layers=6, num_decoder_layers=6, num_heads=8)


def t5_large() -> T5Config:
    return T5Config(d_model=1024, d_ff=4096, num_layers=24, num_decoder_layers=24, num_heads=16)


def t5_3b() -> T5Config:
    # reference ships start-token embeds for t5-3b too (d_model 1024,
    # t5_decoder_start_token_embeds/, loaded at t5_generative_retriever.py:116-135)
    return T5Config(d_model=1024, d_ff=16384, num_layers=24,
                    num_decoder_layers=24, num_heads=32, d_kv=128)


_NAMED_T5 = {"t5-small": t5_small, "t5-base": t5_base, "t5-large": t5_large,
             "t5-3b": t5_3b}


@dataclasses.dataclass(frozen=True)
class RiporConfig:
    """T5 backbone + DocID geometry.

    ``M`` smtid positions, each with its own K-entry codebook of dim d_model
    (reference: per-position ``list_decoder_embeds`` ModuleList,
    modeling/t5_generative_retriever.py:103-109 — here a single [M, K, d]
    tensor so per-position ops become einsums over the position axis).

    ``shared_output_input_embeds``: when True the decoder input embedding
    tables double as the output-projection tables (reference
    ``shared_output_input_embeds``, t5_generative_retriever.py:55,103-109).
    """

    t5: T5Config = dataclasses.field(default_factory=t5_base)
    M: int = 32                # number of smtid positions (codebooks)
    K: int = 256               # codes per codebook (decoder_vocab_sizes[i])
    shared_output_input_embeds: bool = True
    apply_log_softmax: bool = False  # reference defaults to raw IP scores (generation.py:453-458)
    # scale decoder hidden by d_model**-0.5 before the lm head (reference
    # ``scaleup_output_hidden``, t5_generative_retriever.py:53,427-428)
    scaleup_output_hidden: bool = False

    @property
    def max_decode_len(self) -> int:
        return self.M

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RiporConfig":
        d = json.loads(s)
        d["t5"] = T5Config(**d["t5"])
        return RiporConfig(**d)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path: str | Path) -> "RiporConfig":
        return RiporConfig.from_json(Path(path).read_text())


def ripor_base(M: int = 32, K: int = 256, **kw) -> RiporConfig:
    return RiporConfig(t5=t5_base(), M=M, K=K, **kw)


def ripor_small(M: int = 8, K: int = 32, **kw) -> RiporConfig:
    """Tiny geometry for tests."""
    return RiporConfig(
        t5=T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                    num_decoder_layers=2, num_heads=4, dropout_rate=0.0),
        M=M, K=K, **kw)


def named_t5(name: str) -> T5Config:
    return _NAMED_T5[name]()
