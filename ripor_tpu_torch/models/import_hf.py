"""HF checkpoint import — pretrained T5 and BERT weights into the port's
models, from a local file (nothing is downloaded).

Port of ripor_tpu/models/import_hf.py. The reference fine-tunes HF
``t5-base`` (modeling/t5_generative_retriever.py:70, from_pretrained at
:521) and scores with a pretrained MiniLM cross-encoder
(modeling/cross_encoder.py:12). These functions map an HF state dict
(torch tensors or numpy arrays) straight onto the port's state_dict
names; an HF Linear weight is [out, in], as a torch Linear's, so nothing
is transposed. The codebook head and ``start_embed`` have no HF
counterpart and are left as the template has them; the HF lm_head is
dropped. Covers T5 v1.0 and v1.1 (gated FFN) encoder + decoder stacks.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.asarray(x, np.float32))


def _putter(params: Mapping[str, torch.Tensor]):
    """A copy of ``params`` and a put(name, value) that writes value over
    the entry ``name``, checking its shape and keeping its dtype and
    device."""
    out = dict(params)

    def put(name: str, value):
        v = _tensor(value)
        if tuple(out[name].shape) != tuple(v.shape):
            raise ValueError(f"{name}: {tuple(out[name].shape)} vs "
                             f"{tuple(v.shape)}")
        out[name] = v.to(dtype=out[name].dtype, device=out[name].device)
    return out, put


def hf_t5_to_params(state: Mapping, params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Fill a RiporModel (or T5DenseEncoder) state_dict from an HF T5 state
    dict. ``params`` is a template (e.g. from init_params) whose shapes are
    verified. Returns a new state_dict; codebooks/start_embed are left
    untouched. The relative-position tables come from block 0 of each
    stack, the only block that holds one."""
    out, put = _putter(params)
    put("shared.weight", state["shared.weight"])

    def stack(side: str, n_layers: int):
        is_enc = side == "encoder"
        for i in range(n_layers):
            hf = f"{side}.block.{i}.layer"
            ours = f"{side}.layers.{i}"
            attn = "attn" if is_enc else "self_attn"
            for m in ("q", "k", "v", "o"):
                put(f"{ours}.{attn}.{m}.weight",
                    state[f"{hf}.0.SelfAttention.{m}.weight"])
            put(f"{ours}.{attn}_norm.scale", state[f"{hf}.0.layer_norm.weight"])
            li = 1
            if not is_enc:
                for m in ("q", "k", "v", "o"):
                    put(f"{ours}.cross_attn.{m}.weight",
                        state[f"{hf}.1.EncDecAttention.{m}.weight"])
                put(f"{ours}.cross_attn_norm.scale",
                    state[f"{hf}.1.layer_norm.weight"])
                li = 2
            ff = f"{hf}.{li}.DenseReluDense"
            if f"{ff}.wi.weight" in state:
                put(f"{ours}.ffn.wi.weight", state[f"{ff}.wi.weight"])
            else:  # v1.1 gated
                put(f"{ours}.ffn.wi_0.weight", state[f"{ff}.wi_0.weight"])
                put(f"{ours}.ffn.wi_1.weight", state[f"{ff}.wi_1.weight"])
            put(f"{ours}.ffn.wo.weight", state[f"{ff}.wo.weight"])
            put(f"{ours}.ffn_norm.scale", state[f"{hf}.{li}.layer_norm.weight"])
        put(f"{side}.rel_bias.rel_embedding",
            state[f"{side}.block.0.layer.0.SelfAttention"
                  f".relative_attention_bias.weight"])
        put(f"{side}.final_norm.scale", state[f"{side}.final_layer_norm.weight"])

    for side in ("encoder", "decoder"):
        stack(side, max(int(k.split(".")[2]) for k in state
                        if k.startswith(f"{side}.block.")) + 1)
    return out


def hf_bert_to_params(state: Mapping, params: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """Fill a BertCrossEncoder / BertDenseEncoder state_dict from an HF
    BERT-class state dict (BertForSequenceClassification for the MiniLM
    teacher the reference loads at modeling/cross_encoder.py:12, or a bare
    BertModel for the DenseEncoder baseline, modeling/dense_encoder.py:8).

    Accepts keys with or without the ``bert.`` prefix; the pooler and the
    classifier (whose key has no prefix) are filled only when present in
    both the state dict and the template."""
    out, put = _putter(params)
    prefix = "bert." if any(k.startswith("bert.") for k in state) else ""

    def get(key: str):
        return state[prefix + key] if prefix + key in state else state[key]

    def has(key: str) -> bool:
        return prefix + key in state or key in state

    emb = "embeddings"
    put("bert.word.weight", get(f"{emb}.word_embeddings.weight"))
    put("bert.position.weight", get(f"{emb}.position_embeddings.weight"))
    put("bert.type.weight", get(f"{emb}.token_type_embeddings.weight"))
    put("bert.emb_norm.scale", get(f"{emb}.LayerNorm.weight"))
    put("bert.emb_norm.bias", get(f"{emb}.LayerNorm.bias"))

    n_layers = max(int(k.split("encoder.layer.")[1].split(".")[0])
                   for k in state if "encoder.layer." in k) + 1
    for i in range(n_layers):
        hf = f"encoder.layer.{i}"
        ours = f"bert.layers.{i}"
        for mine, theirs in (("attn.q", "attention.self.query"),
                             ("attn.k", "attention.self.key"),
                             ("attn.v", "attention.self.value"),
                             ("attn.o", "attention.output.dense"),
                             ("ffn_wi", "intermediate.dense"),
                             ("ffn_wo", "output.dense")):
            put(f"{ours}.{mine}.weight", get(f"{hf}.{theirs}.weight"))
            put(f"{ours}.{mine}.bias", get(f"{hf}.{theirs}.bias"))
        for mine, theirs in (("attn_norm", "attention.output.LayerNorm"),
                             ("ffn_norm", "output.LayerNorm")):
            put(f"{ours}.{mine}.scale", get(f"{hf}.{theirs}.weight"))
            put(f"{ours}.{mine}.bias", get(f"{hf}.{theirs}.bias"))

    if "pooler.weight" in out and has("pooler.dense.weight"):
        put("pooler.weight", get("pooler.dense.weight"))
        put("pooler.bias", get("pooler.dense.bias"))
    if "classifier.weight" in out and "classifier.weight" in state:
        put("classifier.weight", state["classifier.weight"])
        put("classifier.bias", state["classifier.bias"])
    return out


def load_hf_t5_file(path: str) -> Dict:
    """Read an HF checkpoint file (pytorch_model.bin, or model.safetensors,
    which needs the ``safetensors`` package) -> its state dict."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)
