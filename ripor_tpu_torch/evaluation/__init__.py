from ripor_tpu_torch.evaluation.metrics import (
    evaluate_run,
    load_and_evaluate,
    mrr_k,
    ndcg_cut_k,
    qrel_to_smtid_qrel,
    recall_k,
    truncate_run,
)
from ripor_tpu_torch.evaluation.bm25 import BM25Index
from ripor_tpu_torch.evaluation.hnsw import HnswIndex, recall_vs_exact
from ripor_tpu_torch.evaluation.retriever import (
    Int8Corpus,
    dense_topk,
    device_corpus,
    encode_corpus,
    retrieve_to_run,
)

__all__ = [
    "mrr_k", "recall_k", "ndcg_cut_k", "evaluate_run", "load_and_evaluate",
    "truncate_run", "qrel_to_smtid_qrel",
    "dense_topk", "device_corpus", "Int8Corpus", "encode_corpus",
    "retrieve_to_run",
    "HnswIndex", "recall_vs_exact",
    "BM25Index",
]
