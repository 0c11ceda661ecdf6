from ripor_tpu_torch.pipeline.recipe import (
    Workspace,
    load_tokenizer,
    stage_build_docids,
    stage_build_trie,
    stage_encode_corpus,
    stage_evaluate,
    stage_install_codebooks,
    stage_retrieve,
    stage_tokenizer,
    stage_train,
)

__all__ = ["Workspace", "load_tokenizer", "stage_build_docids",
           "stage_build_trie", "stage_encode_corpus", "stage_evaluate",
           "stage_install_codebooks", "stage_retrieve", "stage_tokenizer",
           "stage_train"]
