from ripor_tpu_torch.pipeline.datagen import (
    DECAY_TO_FACTOR,
    MNT_TO_SMTID_FACTOR,
    add_qrel_examples,
    attach_lng_knp_scores,
    build_bce_examples,
    expand_prefix_rankdata,
    group_docids_by_prefix,
    merge_rankdata_with_decay,
    merge_self_neg_sym_neg,
    nway_dataset,
    nway_labels,
    prefix_smtid_strings,
    pseudo_query_examples,
    qrel_first_examples,
    truncate_examples,
)
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
from ripor_tpu_torch.pipeline.runner import PipelineManifest, run_pipeline

__all__ = [
    "DECAY_TO_FACTOR", "MNT_TO_SMTID_FACTOR", "attach_lng_knp_scores",
    "expand_prefix_rankdata", "group_docids_by_prefix",
    "merge_rankdata_with_decay", "prefix_smtid_strings", "Workspace",
    "pseudo_query_examples", "build_bce_examples", "nway_labels",
    "nway_dataset", "truncate_examples", "qrel_first_examples",
    "merge_self_neg_sym_neg", "add_qrel_examples",
    "run_pipeline", "PipelineManifest",
    "load_tokenizer", "stage_build_docids", "stage_build_trie",
    "stage_encode_corpus", "stage_evaluate", "stage_install_codebooks",
    "stage_retrieve", "stage_tokenizer", "stage_train",
]
