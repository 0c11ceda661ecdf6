from ripor_tpu_torch.evaluation.metrics import (
    evaluate_run,
    load_and_evaluate,
    mrr_k,
    ndcg_cut_k,
    qrel_to_smtid_qrel,
    recall_k,
    truncate_run,
)
from ripor_tpu_torch.evaluation.retriever import retrieve_to_run

__all__ = [
    "mrr_k", "recall_k", "ndcg_cut_k", "evaluate_run", "load_and_evaluate",
    "truncate_run", "qrel_to_smtid_qrel", "retrieve_to_run",
]
