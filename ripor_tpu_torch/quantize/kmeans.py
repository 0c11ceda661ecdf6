"""k-means in PyTorch (replaces faiss's CPU k-means inside
IndexResidualQuantizer; reference call site tasks/evaluator.py:406-421).

Port of ripor_tpu/quantize/kmeans.py. The distance is ||x||^2 - 2 x C^T +
||C||^2, one f32 matmul; cluster sums go through ``index_add_`` and counts
through ``bincount`` where the JAX package multiplies by an [N, K] one-hot
matrix (the same function without the one-hot transient, 1 GB at N = 1M).

Randomness comes from an explicit ``torch.Generator`` on the data's device
where the JAX functions take a key: the draws have the same distributions,
not the same values. Every f32 product here runs with TF32 off (``exact_f32``):
near-tie assignments flip under TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from ripor_tpu_torch.decode.beam import resolve_device


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls in full precision (no TF32) inside the block; the
    caller's setting is restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def default_generator(device) -> torch.Generator:
    """The generator a function draws from when the caller passes none:
    seed 0 on ``device``, as the JAX functions default to PRNGKey(0)."""
    return torch.Generator(device=device).manual_seed(0)


def assign_codes(x: torch.Tensor, centroids: torch.Tensor,
                 block: int = 0) -> torch.Tensor:
    """Nearest-centroid assignment. x: [N, d], centroids: [K, d] -> [N]
    int32 on x's device. Squared-L2 argmin == argmax(x·c - ||c||^2/2); one
    matmul. Ties go to the lower index, as jnp.argmin. ``block`` is read by
    neither package (the JAX signature's)."""
    with exact_f32():
        logits = x @ centroids.T - 0.5 * torch.sum(centroids * centroids,
                                                   dim=-1)[None]
    return torch.argmin(-logits, dim=-1).to(torch.int32)


def _cluster_stats(x, assign, k):
    """(sums [K, d], counts [K]) of the rows of x per assigned cluster."""
    sums = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.bincount(assign, minlength=k).to(x.dtype)
    return sums, counts


def _lloyd_step(x, centroids, generator):
    k = centroids.shape[0]
    assign = assign_codes(x, centroids)
    sums, counts = _cluster_stats(x, assign, k)
    new_centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    # empty-cluster repair: re-seed dead centroids from random points
    # (faiss does the same during its k-means); drawn every step, as the
    # reference draws its key every step
    rand_idx = torch.randint(0, x.shape[0], (k,), generator=generator,
                             device=x.device)
    new_centroids = torch.where((counts > 0)[:, None], new_centroids,
                                x[rand_idx])
    return new_centroids, assign


def _kmeanspp_init(x: torch.Tensor, k: int,
                   generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding: each new centroid sampled with prob ∝ D(x)^2.

    One distance update per step, only against the newest centroid. The
    update is ||x||^2 - 2 x·c + ||c||^2 (one matrix-vector product, no
    [N, d] transient), clamped at 0; the JAX package sums (x - c)^2. It
    only weighs a random draw, which no parity test compares."""
    n, d = x.shape
    first = int(torch.randint(0, n, (), generator=generator,
                              device=x.device))
    centroids = torch.zeros(k, d, dtype=x.dtype, device=x.device)
    centroids[0] = x[first]
    with exact_f32():
        x2 = torch.sum(x * x, dim=-1)

        def dist2(c):
            return torch.clamp(x2 - 2.0 * (x @ c) + torch.dot(c, c), min=0.0)

        d2 = dist2(x[first])
        for i in range(1, k):
            probs = d2 / torch.clamp(torch.sum(d2), min=1e-12)
            # categorical(log(probs + 1e-30)): the floor keeps every row
            # drawable (a uniform draw when all distances are 0)
            idx = torch.multinomial(probs + 1e-30, 1, generator=generator)[0]
            c = x[idx]
            centroids[i] = c
            d2 = torch.minimum(d2, dist2(c))
    return centroids


def kmeans_fit(x: torch.Tensor, k: int, iters: int = 20,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit k centroids with Lloyd's algorithm, k-means++ init, on x's
    device. Returns (centroids [K, d], assignments [N]); the assignments
    are those of the last step's input centroids, as the reference's."""
    if generator is None:
        generator = default_generator(x.device)
    centroids = _kmeanspp_init(x, k, generator)
    assign = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
    for _ in range(iters):
        centroids, assign = _lloyd_step(x, centroids, generator)
    return centroids, assign


def kmeans_fit_batched(x, k: int, iters: int = 20,
                       generator: Optional[torch.Generator] = None,
                       batch: int = 1_000_000, device=None) -> torch.Tensor:
    """Host-driven k-means for datasets too large for one device buffer:
    each Lloyd iteration streams batches of x (numpy, e.g. a memmap) to
    ``device`` (default "cuda"), which computes assignments and partial
    sums; the host accumulates them in float64. Use kmeans_fit when x fits
    on the device. Returns the centroids [K, d] on ``device``. The initial
    centroids and the re-seeds come from a numpy generator seeded by one
    draw from ``generator``."""
    dev = resolve_device(device)
    if generator is None:
        generator = default_generator(dev)
    x = np.asarray(x)
    n, d = x.shape
    rng = np.random.default_rng(int(torch.randint(
        0, 2**31 - 1, (), generator=generator, device=generator.device)))
    centroids = torch.as_tensor(
        np.asarray(x[rng.choice(n, size=k, replace=n < k)], np.float32),
        device=dev)

    for _ in range(iters):
        sums = np.zeros((k, d), np.float64)
        counts = np.zeros((k,), np.float64)
        for s in range(0, n, batch):
            xb = torch.as_tensor(np.asarray(x[s:s + batch], np.float32),
                                 device=dev)
            bs, bc = _cluster_stats(xb, assign_codes(xb, centroids), k)
            sums += bs.cpu().numpy().astype(np.float64)
            counts += bc.cpu().numpy().astype(np.float64)
        new = sums / np.maximum(counts, 1.0)[:, None]
        dead = counts == 0
        if dead.any():
            new[dead] = x[rng.choice(n, size=int(dead.sum()))]
        centroids = torch.as_tensor(new.astype(np.float32), device=dev)
    return centroids
