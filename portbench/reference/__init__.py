"""The plain reference the benchmark holds the program's answers against.
It imports nothing of the program (ripor_tpu_torch) and nothing of JAX."""
from portbench.reference.t5 import Reference, exact_float32
from portbench.reference.tokens import query_ids

__all__ = ["Reference", "exact_float32", "query_ids"]
