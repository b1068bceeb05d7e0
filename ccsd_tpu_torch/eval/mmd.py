"""MMD machinery: kernels over histograms and discrepancy sums.

Port copy of ccsd_tpu/eval/mmd.py:1-137 (numpy only), without
``compute_nspdk_mmd`` (molecules).  The 1-D EMD under the |i - j| ground
metric is the L1 distance of the two CDFs, evaluated in closed form, and
the discrepancy sums are vectorised over the padded sample matrix.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def process_tensor(x: np.ndarray, y: np.ndarray):
    """Zero-pad two vectors to a common support."""
    support = max(len(x), len(y))
    if len(x) < support:
        x = np.hstack([x, np.zeros(support - len(x))])
    if len(y) < support:
        y = np.hstack([y, np.zeros(support - len(y))])
    return x, y


def emd(x: np.ndarray, y: np.ndarray, distance_scaling: float = 1.0) -> float:
    """1-D EMD with |i-j|/distance_scaling ground metric (closed form)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x, y = process_tensor(x, y)
    return float(np.abs(np.cumsum(x - y)[:-1]).sum() / distance_scaling)


def gaussian_emd(
    x: np.ndarray, y: np.ndarray, sigma: float = 1.0, distance_scaling: float = 1.0
) -> float:
    d = emd(x, y, distance_scaling)
    return float(np.exp(-d * d / (2 * sigma * sigma)))


def gaussian(x: np.ndarray, y: np.ndarray, sigma: float = 1.0) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x, y = process_tensor(x, y)
    d = np.linalg.norm(x - y, 2)
    return float(np.exp(-d * d / (2 * sigma * sigma)))


def gaussian_tv(x: np.ndarray, y: np.ndarray, sigma: float = 1.0) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    x, y = process_tensor(x, y)
    d = np.abs(x - y).sum() / 2.0
    return float(np.exp(-d * d / (2 * sigma * sigma)))


def _pairwise_kernel_matrix(A: np.ndarray, B: np.ndarray, kernel, **kw) -> np.ndarray:
    """Vectorized kernel matrices for the known kernels; generic fallback."""
    sigma = kw.get("sigma", 1.0)
    scaling = kw.get("distance_scaling", 1.0)
    if kernel is gaussian_emd:
        ca = np.cumsum(A, axis=1)[:, :-1]
        cb = np.cumsum(B, axis=1)[:, :-1]
        d = np.abs(ca[:, None, :] - cb[None, :, :]).sum(-1) / scaling
        return np.exp(-d * d / (2 * sigma * sigma))
    if kernel is gaussian:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * sigma * sigma))
    if kernel is gaussian_tv:
        d = np.abs(A[:, None, :] - B[None, :, :]).sum(-1) / 2.0
        return np.exp(-d * d / (2 * sigma * sigma))
    out = np.empty((A.shape[0], B.shape[0]))
    for i in range(A.shape[0]):
        for j in range(B.shape[0]):
            out[i, j] = kernel(A[i], B[j], **kw)
    return out


def disc(
    samples1: Sequence[np.ndarray],
    samples2: Sequence[np.ndarray],
    kernel: Callable,
    **kwargs,
) -> float:
    """Mean pairwise kernel value."""
    if len(samples1) == 0 or len(samples2) == 0:
        return 0.0
    support = max(
        max(len(s) for s in samples1), max(len(s) for s in samples2)
    )
    A = np.zeros((len(samples1), support))
    for i, s in enumerate(samples1):
        A[i, : len(s)] = s
    B = np.zeros((len(samples2), support))
    for i, s in enumerate(samples2):
        B[i, : len(s)] = s
    K = _pairwise_kernel_matrix(A, B, kernel, **kwargs)
    return float(K.sum() / (len(samples1) * len(samples2)))


def compute_mmd(
    samples1: Sequence[np.ndarray],
    samples2: Sequence[np.ndarray],
    kernel: Callable,
    is_hist: bool = True,
    **kwargs,
) -> float:
    """MMD^2 = K(xx) + K(yy) - 2 K(xy)."""
    if is_hist:
        samples1 = [s / np.sum(s) if np.sum(s) else s for s in samples1]
        samples2 = [s / np.sum(s) if np.sum(s) else s for s in samples2]
    return (
        disc(samples1, samples1, kernel, **kwargs)
        + disc(samples2, samples2, kernel, **kwargs)
        - 2 * disc(samples1, samples2, kernel, **kwargs)
    )
