"""Residual quantization (RQ) — how DocIDs are made, in PyTorch.

Port of ripor_tpu/quantize/rq.py (replaces faiss ``IndexResidualQuantizer``
of the reference: tasks/evaluator.py:406-421 trains it on the 8.8M x 768
embedding mmap; aq_preprocess/create_customized_smtid_file.py:33-59
extracts the codes; change_customized_embed_layer.py:44-81 reads the
codebooks into the model). ``train_rq`` fits the [M, K, d] codebook tensor
(the layout of ``RiporModel.codebooks``: models/ripor.py::install_codebooks),
``rq_encode`` assigns codes by beam search over stages, ``rq_decode``
reconstructs. The products are f32 matmuls with TF32 off.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ripor_tpu_torch.decode.beam import resolve_device
from ripor_tpu_torch.quantize.kmeans import (assign_codes, default_generator,
                                             exact_f32, kmeans_fit,
                                             kmeans_fit_batched)


@dataclasses.dataclass
class RQCodebooks:
    """codebooks: [M, K, d] float32 — same layout as RiporModel.codebooks."""

    codebooks: np.ndarray

    @property
    def M(self) -> int:
        return self.codebooks.shape[0]

    @property
    def K(self) -> int:
        return self.codebooks.shape[1]

    @property
    def d(self) -> int:
        return self.codebooks.shape[2]

    def save(self, path: str) -> None:
        """np.save: a path without the .npy suffix gets it appended (the
        JAX CLI's ``codebooks.npz`` lands as ``codebooks.npz.npy``)."""
        np.save(path, self.codebooks)

    @staticmethod
    def load(path: str) -> "RQCodebooks":
        return RQCodebooks(np.load(path))


def _device_f32(x, device) -> torch.Tensor:
    """x (numpy, memmap or tensor) as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def train_rq(x, M: int, K: int, kmeans_iters: int = 25,
             generator: Optional[torch.Generator] = None, batch: int = 0,
             device=None) -> RQCodebooks:
    """Fit M residual-stage codebooks of K centroids each on x [N, d].

    Stage m runs k-means on the residuals after subtracting stages < m
    (greedy residual training, faiss's default). x (numpy, a memmap or a
    tensor) is moved to ``device`` (default "cuda"; a tensor already there
    stays). ``batch`` > 0 streams a numpy x larger than the device through
    kmeans_fit_batched, with the residuals kept on the host. ``generator``
    (default seed 0 on the device) feeds every stage's draws in turn."""
    dev = resolve_device(device)
    if generator is None:
        generator = default_generator(dev)
    books = []
    if batch:
        # residuals are updated in place per stage; copy (the input is
        # typically a read-only memmap of the corpus embeddings)
        residual = np.array(x, np.float32, copy=True)
        for _ in range(M):
            centroids = kmeans_fit_batched(residual, K, kmeans_iters,
                                           generator, batch, dev)
            host = centroids.cpu().numpy()
            for s in range(0, residual.shape[0], batch):
                blk = torch.as_tensor(residual[s:s + batch], device=dev)
                a = assign_codes(blk, centroids).cpu().numpy()
                residual[s:s + batch] -= host[a]
            books.append(host)
    else:
        residual = _device_f32(x, dev)
        for _ in range(M):
            centroids, assign = kmeans_fit(residual, K, kmeans_iters,
                                           generator)
            books.append(centroids.cpu().numpy())
            residual = residual - centroids[assign]
    return RQCodebooks(np.stack(books, axis=0))


def _rq_beam_encode(x: torch.Tensor, books: torch.Tensor, beam: int):
    """Beam-search RQ encoding. x: [N, d], books: [M, K, d] (f32, one
    device) -> (codes [N, M] int32, err [N]). Each stage scores beam x K
    candidates and keeps the best ``beam`` (torch.topk over beam*K).
    ``err`` is what the beam ranks by, as in the JAX function: a
    candidate's score adds its squared residual norm to its beam's
    ``err``, so ``err`` sums the squared residual norms of every stage
    (the JAX docstring calls it the final squared error)."""
    n, d = x.shape
    M, K, _ = books.shape
    if beam > K:
        raise ValueError("beam width cannot exceed codebook size")
    residual = x[:, None, :].expand(n, beam, d).to(torch.float32)
    codes = torch.zeros(n, beam, M, dtype=torch.int32, device=x.device)
    # only beam slot 0 is live initially (others would duplicate it)
    err = torch.full((beam,), float("inf"), device=x.device)
    err[0] = 0.0
    err = err[None, :].expand(n, beam)
    with exact_f32():
        for m in range(M):
            book = books[m]                                  # [K, d]
            dots = torch.einsum("nbd,kd->nbk", residual, book)
            c2 = torch.sum(book * book, dim=-1)
            r2 = torch.sum(residual * residual, dim=-1, keepdim=True)
            cand = err[:, :, None] + r2 - 2.0 * dots + c2[None, None, :]
            del dots, r2
            neg_err, top_idx = torch.topk(-cand.reshape(n, beam * K), beam)
            del cand
            src = top_idx // K                               # [N, beam]
            tok = (top_idx % K).to(torch.int32)
            residual = torch.gather(residual, 1,
                                    src[:, :, None].expand(n, beam, d))
            residual -= book[tok]
            codes = torch.gather(codes, 1, src[:, :, None].expand(n, beam, M))
            codes[:, :, m] = tok
            err = -neg_err
    return codes[:, 0, :], err[:, 0]


def rq_encode(books: RQCodebooks | np.ndarray, x, beam: int = 4,
              block: int = 262_144, device=None) -> np.ndarray:
    """Assign RQ codes to x [N, d] -> [N, M] int32 (replaces
    ``rq.compute_codes`` + faiss BitstringReader unpacking,
    create_customized_smtid_file.py:34-45). Streams blocks of ``block``
    rows through ``device`` (default "cuda"; a tensor x is sliced where it
    lies and its blocks moved there)."""
    dev = resolve_device(device)
    books_t = torch.as_tensor(np.asarray(
        books.codebooks if isinstance(books, RQCodebooks) else books,
        np.float32), device=dev)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, np.float32)
    outs = []
    for s in range(0, x.shape[0], block):
        codes, _ = _rq_beam_encode(_device_f32(x[s:s + block], dev),
                                   books_t, beam)
        outs.append(codes.cpu().numpy())
    return np.concatenate(outs, axis=0)


def rq_decode(books: RQCodebooks | np.ndarray, codes) -> np.ndarray:
    """Reconstruct vectors from codes [N, M] -> [N, d] (numpy, on the host)."""
    b = np.asarray(books.codebooks if isinstance(books, RQCodebooks) else books)
    codes = np.asarray(codes)
    M = b.shape[0]
    return b[np.arange(M)[None, :], codes].sum(axis=1)


def reconstruction_mse(books, x, codes=None, beam: int = 4,
                       device=None) -> float:
    x = np.asarray(x, np.float32)
    if codes is None:
        codes = rq_encode(books, x, beam=beam, device=device)
    recon = rq_decode(books, codes)
    return float(np.mean(np.sum((x - recon) ** 2, axis=-1)))
