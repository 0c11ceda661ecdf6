from ripor_tpu_torch.pipeline.recipe import (
    Workspace,
    load_tokenizer,
    stage_build_trie,
    stage_evaluate,
    stage_retrieve,
    stage_train,
)

__all__ = ["Workspace", "load_tokenizer", "stage_build_trie",
           "stage_evaluate", "stage_retrieve", "stage_train"]
