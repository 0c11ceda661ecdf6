"""ripor_tpu_torch — the PyTorch/CUDA port of ripor_tpu for NVIDIA Hopper.

The JAX package ``ripor_tpu`` is the reference; this package mirrors its
module paths and public names so each counterpart is easy to find, and is
held against it by the parity tests in ``tests/test_torch_*.py``. It
imports torch and never jax, flax or any ``ripor_tpu`` module.

Ported so far: the query-time retrieval path from its entry points
down — cli/ (retrieve, retrieve-merge, evaluate, serve), pipeline/recipe
(workspace stages), train/checkpoint, data/ (tokenizer, datasets),
evaluation/ (trec metrics), native_ext (the C++ host library), models/
(T5 + RIPOR head), trie/, decode/ (beam search on its four paths, the
quant gate), ops/ (the int8-weight FFN and the eight hand-written Hopper
kernels, sources in csrc/) and serve/ (RetrievalEngine, HTTP). Entry
points run on "cuda" unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from ripor_tpu_torch.models.config import RiporConfig, T5Config  # noqa: F401
from ripor_tpu_torch.decode.beam import (  # noqa: F401
    BeamSearchOutput,
    beam_search,
    expand_groups_to_docids,
    make_beam_search_fn,
)

__all__ = ["BeamSearchOutput", "beam_search", "make_beam_search_fn",
           "expand_groups_to_docids", "RiporConfig", "T5Config"]
