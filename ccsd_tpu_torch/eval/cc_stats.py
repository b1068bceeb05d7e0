"""Combinatorial-complex MMD statistics.

Port copy of ccsd_tpu/eval/cc_stats.py: Hodge-Laplacian spectrum, rank-0/1
value histograms, rank-2 size histogram, and the evaluation driver and its
default settings.  The predicted CCs are filtered by ``is_empty_cc``, the
reference ones are not.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ccsd_tpu_torch.data.cc_codec import CC_to_incidence_matrices, pad_rank2
from ccsd_tpu_torch.data.complex import CombinatorialComplex
from ccsd_tpu_torch.eval.mmd import compute_mmd, gaussian_emd


def is_empty_cc(cc: CombinatorialComplex) -> bool:
    return cc.number_of_cells() == 0


def hodge_laplacian_spectrum_worker(
    CC: CombinatorialComplex, d_min: int, d_max: int, N: int
) -> np.ndarray:
    """Eigenvalues of H = F F^T on the padded incidence matrix."""
    _, _, F = CC_to_incidence_matrices(CC, d_min, d_max)
    if F.size:
        padded = pad_rank2(F, N, d_min, d_max)
        H = padded @ padded.T
        try:
            return np.linalg.eigvalsh(H).astype(np.float32)
        except np.linalg.LinAlgError:  # no convergence: zeros, as the reference
            return np.zeros((F.shape[-2],), dtype=np.float32)
    return np.zeros(((N * (N - 1)) // 2,), dtype=np.float32)


def rank0_distrib_worker(
    CC: CombinatorialComplex, min_node_val: int, max_node_val: int,
    node_label: str = "label",
) -> np.ndarray:
    cells = CC.cells.hyperedge_dict.get(0, {})
    hist = np.zeros(max_node_val - min_node_val + 1, dtype=np.float32)
    for cell in cells:
        val = int(cells[cell][node_label])
        if min_node_val <= val <= max_node_val:
            hist[val - min_node_val] += 1
    return hist


def rank1_distrib_worker(
    CC: CombinatorialComplex, min_edge_val: int, max_edge_val: int,
    edge_label: str = "label",
) -> np.ndarray:
    cells = CC.cells.hyperedge_dict.get(1, {})
    hist = np.zeros(max_edge_val - min_edge_val + 1, dtype=np.float32)
    for cell in cells:
        val = int(cells[cell][edge_label])
        if min_edge_val <= val <= max_edge_val:
            hist[val - min_edge_val] += 1
    return hist


def rank2_distrib_worker(
    CC: CombinatorialComplex, d_min: int, d_max: int
) -> np.ndarray:
    cells = CC.cells.hyperedge_dict.get(2, {})
    hist = np.zeros(d_max - d_min + 1, dtype=np.float32)
    for cell in cells:
        if d_min <= len(cell) <= d_max:
            hist[len(cell) - d_min] += 1
    return hist


def _stats(worker, extract_kwargs):
    def stats_fn(cc_ref_list, cc_pred_list, worker_kwargs, kernel=gaussian_emd,
                 **_):
        kw = extract_kwargs(worker_kwargs)
        pred = [cc for cc in cc_pred_list if not is_empty_cc(cc)]
        sample_ref = [worker(cc, **kw) for cc in cc_ref_list]
        sample_pred = [worker(cc, **kw) for cc in pred]
        return compute_mmd(sample_ref, sample_pred, kernel=kernel)

    return stats_fn


hodge_laplacian_spectrum_stats = _stats(
    hodge_laplacian_spectrum_worker,
    lambda w: {"d_min": w["d_min"], "d_max": w["d_max"], "N": w["N"]},
)
rank0_distrib_stats = _stats(
    rank0_distrib_worker,
    lambda w: {"min_node_val": w["min_node_val"],
               "max_node_val": w["max_node_val"],
               "node_label": w["node_label"]},
)
rank1_distrib_stats = _stats(
    rank1_distrib_worker,
    lambda w: {"min_edge_val": w["min_edge_val"],
               "max_edge_val": w["max_edge_val"],
               "edge_label": w["edge_label"]},
)
rank2_distrib_stats = _stats(
    rank2_distrib_worker,
    lambda w: {"d_min": w["d_min"], "d_max": w["d_max"]},
)

CC_METHOD_NAME_TO_FUNC = {
    "hodge_laplacian_spectrum": hodge_laplacian_spectrum_stats,
    "rank0_distrib": rank0_distrib_stats,
    "rank1_distrib": rank1_distrib_stats,
    "rank2_distrib": rank2_distrib_stats,
}


def load_cc_eval_settings():
    """Default CC eval settings."""
    methods = [
        "hodge_laplacian_spectrum",
        "rank0_distrib",
        "rank1_distrib",
        "rank2_distrib",
    ]
    kernels = {m: gaussian_emd for m in methods}
    return methods, kernels


def eval_CC_list(
    cc_ref_list: List[CombinatorialComplex],
    cc_pred_list: List[CombinatorialComplex],
    worker_kwargs: Dict[str, Any],
    methods: Optional[List[str]] = None,
    kernels: Optional[Dict[str, Callable]] = None,
    cc_nb_eval: Optional[int] = 1000,
) -> Dict[str, float]:
    """Evaluate generated CCs against a reference set: the first
    ``cc_nb_eval`` of each, each MMD rounded to 6 decimals."""
    if methods is None:
        methods, default_kernels = load_cc_eval_settings()
        kernels = kernels or default_kernels
    results = {}
    ref = cc_ref_list[:cc_nb_eval] if cc_nb_eval is not None else cc_ref_list
    pred = cc_pred_list[:cc_nb_eval] if cc_nb_eval is not None else cc_pred_list
    for method in methods:
        results[method] = round(
            CC_METHOD_NAME_TO_FUNC[method](ref, pred, worker_kwargs,
                                           kernels[method]),
            6,
        )
    return results
