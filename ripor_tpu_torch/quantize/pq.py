"""Product quantization — the PQ baseline indexer, in PyTorch.

Port of ripor_tpu/quantize/pq.py (replaces faiss ``IndexPQ``, reference
ProductQuantizeIndexer, tasks/evaluator.py:265-288): the d-dim space splits
into M subspaces of d/M dims, each with its own K-entry codebook fitted by
an independent k-means.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ripor_tpu_torch.decode.beam import resolve_device

from ripor_tpu_torch.quantize.kmeans import (default_generator, exact_f32,
                                             kmeans_fit)
from ripor_tpu_torch.quantize.rq import _device_f32


@dataclasses.dataclass
class PQCodebooks:
    """codebooks: [M, K, d/M] float32."""

    codebooks: np.ndarray

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def K(self) -> int:
        return self.codebooks.shape[1]

    def save(self, path: str) -> None:
        np.save(path, self.codebooks)

    @staticmethod
    def load(path: str) -> "PQCodebooks":
        return PQCodebooks(np.load(path))


def train_pq(x, M: int, K: int, kmeans_iters: int = 25,
             generator: Optional[torch.Generator] = None,
             device=None) -> PQCodebooks:
    """One k-means per subspace, in turn, on ``device`` (default "cuda");
    ``generator`` (default seed 0 there) feeds them in turn."""
    dev = resolve_device(device)
    x = _device_f32(x, dev)
    n, d = x.shape
    if d % M:
        raise ValueError(f"d={d} does not split into M={M} subspaces")
    sub = x.reshape(n, M, d // M)
    if generator is None:
        generator = default_generator(dev)
    books = []
    for m in range(M):
        centroids, _ = kmeans_fit(sub[:, m].contiguous(), K, kmeans_iters,
                                  generator)
        books.append(centroids.cpu().numpy())
    return PQCodebooks(np.stack(books))


def pq_encode(books: PQCodebooks | np.ndarray, x, device=None) -> np.ndarray:
    """x [N, d] -> codes [N, M] int32: per subspace, argmin ||x_m - c||^2."""
    dev = resolve_device(device)
    b = torch.as_tensor(np.asarray(
        books.codebooks if isinstance(books, PQCodebooks) else books,
        np.float32), device=dev)
    x = _device_f32(x, dev)
    n, d = x.shape
    M, K, ds = b.shape
    sub = x.reshape(n, M, ds)
    with exact_f32():
        dots = torch.einsum("nms,mks->nmk", sub, b)
    c2 = torch.sum(b * b, dim=-1)  # [M, K]
    return torch.argmin(c2[None] - 2 * dots, dim=-1).to(
        torch.int32).cpu().numpy()


def pq_decode(books: PQCodebooks | np.ndarray, codes) -> np.ndarray:
    b = np.asarray(books.codebooks if isinstance(books, PQCodebooks) else books)
    codes = np.asarray(codes)
    M = b.shape[0]
    return b[np.arange(M)[None, :], codes].reshape(codes.shape[0], -1)
