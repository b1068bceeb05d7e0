"""Two-stage open-universe CC generation: (X, A) first, then F | A.

Port of ccsd_tpu/diffusion/two_stage.py:49-416, the factorisation
p(X, A, F) = p(X, A) · p(F | A):

  stage 1  sample (X, A) with the graph PC sampler (``get_pc_sampler``);
  bridge   quantize A on the host and list each sample's candidate rank-2
           cells from its own adjacency by the dataset's lift, padded to
           a slot budget K_max (``dynamic_cells_from_adjs``);
  stage 2  reverse-diffuse F over only those per-sample columns, masked by
           ``mask_rank2_dynamic`` (``get_rank2_sampler``).

The JAX bridge builds a networkx graph per sample; here the candidates come
from the adjacency array: the sources are its non-isolated nodes and the
paths come from ``data.lifts.get_all_paths_from_nodes``, deduplicated and
sorted by (size, nodes) as in the JAX package, so truncation at K_max keeps
the same cells.  Only the path_based lift is ported: the cycles lift needs
a cycle basis, and raises.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccsd_tpu_torch.data.complex import CombinatorialComplex
from ccsd_tpu_torch.data.lifts import get_all_paths_from_nodes
from ccsd_tpu_torch.diffusion.losses import get_score_fn_rank2_dynamic
from ccsd_tpu_torch.diffusion.sde import SDE, _bcast, reverse_discretize, reverse_sde
from ccsd_tpu_torch.diffusion.solvers import _langevin_step
from ccsd_tpu_torch.ops.cells import ComplexSpec
from ccsd_tpu_torch.ops.masks import gen_noise_rank2_dynamic, mask_rank2_dynamic, quantize

Cell = Tuple[int, ...]
CYCLES_NOT_PORTED = ("the cycles lift needs a cycle basis (ccsd_tpu/diffusion/two_stage.py:"
                     "85-88), which is not ported (ROADMAP.md, Queue A, the cycles lift)")
GRAD_FLOOR = 1e-12  # the stage-2 Langevin step's floor on the score's norm


@dataclass(frozen=True)
class DynamicCells:
    """Per-sample candidate-cell universe, padded to a slot budget.

    member: (B, K_max, N) float32 0/1, slot k of sample b holds node n;
    valid: (B, K_max) float32 0/1, the slot is a real candidate;
    cell_lists: per sample, the node tuples of its slots in slot order
    (the host's key to decode generated incidences).
    """

    member: torch.Tensor
    valid: torch.Tensor
    cell_lists: Optional[tuple] = None

    @property
    def k_max(self) -> int:
        return self.member.shape[1]

    def to(self, device) -> "DynamicCells":
        return DynamicCells(self.member.to(device), self.valid.to(device), self.cell_lists)


# --------------------------------------------------------------- bridge -----

def _neighbours(adj: np.ndarray) -> Dict[int, List[int]]:
    """{node: its neighbours} of the non-isolated nodes of a (N, N)
    adjacency, an entry on either side of the diagonal making the edge."""
    a = np.asarray(adj) != 0
    a = a | a.T
    return {int(u): [int(v) for v in np.flatnonzero(a[u])] for u in np.flatnonzero(a.any(1))}


def candidate_cells_from_graph(adj: np.ndarray, d_min: int, d_max: int,
                               lifting_procedure: str = "cycles",
                               path_source_nodes: Optional[Sequence[int]] = None,
                               path_length: Optional[int] = None) -> List[Cell]:
    """Candidate rank-2 cells of one graph (a (N, N) adjacency), sorted by
    (size, nodes).  ``path_based``: the node sets of simple paths of
    ``path_length`` nodes (default d_max) from ``path_source_nodes``
    (default: every non-isolated node), kept where d_min <= size <= d_max."""
    if lifting_procedure == "cycles":
        raise NotImplementedError(CYCLES_NOT_PORTED)
    if lifting_procedure != "path_based":
        raise NotImplementedError(f"Lifting procedure {lifting_procedure} not supported.")
    g = _neighbours(adj)
    sources = list(path_source_nodes) if path_source_nodes is not None else list(g)
    length = path_length if path_length is not None else d_max
    cells = {tuple(sorted(p)) for p in get_all_paths_from_nodes(sources, g, length)
             if d_min <= len(p) <= d_max}
    return sorted(cells, key=lambda c: (len(c), c))


def _pack_cells(per_sample: List[List[Cell]], N: int, k_max: Optional[int]) -> DynamicCells:
    """Slot tensors of per-sample cell lists: K = the longest list (at
    least 1), capped at ``k_max``; later cells are dropped."""
    B = len(per_sample)
    K = max(max((len(c) for c in per_sample), default=1), 1)
    if k_max is not None:
        K = max(1, min(K, k_max))
    member = np.zeros((B, K, N), np.float32)
    valid = np.zeros((B, K), np.float32)
    kept = []
    for b, cells in enumerate(per_sample):
        kept.append(tuple(cells[:K]))
        for j, cell in enumerate(cells[:K]):
            member[b, j, list(cell)] = 1.0
            valid[b, j] = 1.0
    return DynamicCells(torch.from_numpy(member), torch.from_numpy(valid), tuple(kept))


def dynamic_cells_from_adjs(adjs: np.ndarray, d_min: int, d_max: int,
                            k_max: Optional[int] = None, lifting_procedure: str = "cycles",
                            **lift_kwargs) -> DynamicCells:
    """The bridge: (B, N, N) 0/1 adjacencies -> per-sample candidate
    universes (on the host; ``.to(device)`` moves them)."""
    adjs = np.asarray(adjs)
    per_sample = [candidate_cells_from_graph(a, d_min, d_max, lifting_procedure, **lift_kwargs)
                  for a in adjs]
    return _pack_cells(per_sample, adjs.shape[1], k_max)


def dynamic_batch_from_ccs(ccs: Sequence[CombinatorialComplex], spec: ComplexSpec, d_min: int,
                           d_max: int, k_max: Optional[int] = None,
                           lifting_procedure: str = "cycles", **lift_kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor, DynamicCells]:
    """The stage-2 training batch of a CC dataset: each CC's universe is
    listed from its own adjacency (the bridge of sampling time), and the
    target F is 1 on the edges of the candidates that are rank-2 cells of
    the CC, 0 on the others.  Returns (adjs (B, N, N), rank2 (B, E, K_max),
    dyn), on the host."""
    N = spec.N
    adjs = np.zeros((len(ccs), N, N), np.float32)
    actual = []
    for b, cc in enumerate(ccs):
        for e in cc.cells.hyperedge_dict.get(1, {}):
            u, v = tuple(e)
            adjs[b, u, v] = adjs[b, v, u] = 1.0
        actual.append({tuple(sorted(c)) for c in cc.cells.hyperedge_dict.get(2, {})})
    dyn = _pack_cells([candidate_cells_from_graph(a, d_min, d_max, lifting_procedure,
                                                  **lift_kwargs) for a in adjs], N, k_max)
    adjs_t = torch.from_numpy(adjs)
    present = torch.tensor([[float(j < len(cells) and cells[j] in actual[b])
                             for j in range(dyn.k_max)]
                            for b, cells in enumerate(dyn.cell_lists)], dtype=torch.float32)
    rank2 = incidence_from_dynamic(adjs_t, spec, dyn) * present.reshape(len(ccs), 1, -1)
    return adjs_t, rank2, dyn


def incidence_from_dynamic(adjs: torch.Tensor, spec: ComplexSpec,
                           dyn: DynamicCells) -> torch.Tensor:
    """F[b, e, k] = 1 iff edge e = (u, v) is in adjs[b] and u and v are both
    members of the valid slot k (ccsd_tpu/diffusion/two_stage.py:225-243)."""
    u = torch.as_tensor(spec.edge_u, dtype=torch.int64, device=adjs.device)
    v = torch.as_tensor(spec.edge_v, dtype=torch.int64, device=adjs.device)
    edge_present = adjs[:, u, v]  # (B, E)
    in_cell = dyn.member[:, :, u] * dyn.member[:, :, v]  # (B, K, E)
    return edge_present[:, :, None] * in_cell.transpose(1, 2) * dyn.valid[:, None, :]


def ccs_from_two_stage(x: np.ndarray, adj_q: np.ndarray, rank2_q: np.ndarray,
                       dyn: DynamicCells, spec: ComplexSpec,
                       is_molecule: bool = False) -> List[CombinatorialComplex]:
    """Decode generated (x, A, F over the candidates) into CCs: a node for
    each id below the last non-isolated one, an edge for each entry of A
    above the diagonal, and each slot with a nonzero column of F its
    sample's candidate cell."""
    if is_molecule:
        raise NotImplementedError(
            "the molecule decoding of ccs_from_two_stage (QM9, ZINC250k) is not ported "
            "(ROADMAP.md, Queue A, molecules)")
    if dyn.cell_lists is None:
        raise ValueError("the bridge must keep cell_lists")
    u, v = np.asarray(spec.edge_u), np.asarray(spec.edge_v)
    out = []
    for b in range(adj_q.shape[0]):
        cc = CombinatorialComplex()
        A = np.asarray(adj_q[b])
        active = np.nonzero(A.any(axis=0))[0]
        n_max = int(active[-1]) + 1 if active.size else 0
        for n in range(n_max):
            cc.add_cell((n,), rank=0, weight=1)
        for i in np.nonzero(A[u, v])[0]:
            cc.add_cell((int(u[i]), int(v[i])), rank=1, weight=1)
        r = np.asarray(rank2_q[b])
        for j, cell in enumerate(dyn.cell_lists[b]):
            if r[:, j].any():
                cc.add_cell(tuple(int(n) for n in cell), rank=2, weight=1)
        out.append(cc)
    return out


# --------------------------------------------------------- stage-2 sampler --

def get_rank2_sampler(sde_rank2: SDE, spec: ComplexSpec, predictor: str = "Euler",
                      corrector: str = "Langevin", snr: float = 0.1, scale_eps: float = 1.0,
                      n_steps: int = 1, probability_flow: bool = False, denoise: bool = True,
                      eps: float = 1e-3) -> Callable:
    """Reverse diffusion over F alone, with per-sample cell masks
    (ccsd_tpu/diffusion/two_stage.py:284-370).  Returns ``sampler(score_fn,
    dyn, init_flags, generator, shape, stats=None)``, ``score_fn(rank2,
    flags, t)`` the stage-2 score.  Noise is drawn in the JAX order (the
    prior, then per step the corrector's and the predictor's), and the
    Langevin step floors the score's norm at ``GRAD_FLOOR``.  A ``stats``
    dict receives the margin to overflow: ``finite_steps``, the steps
    after which every entry was still finite, and ``max_abs``, the largest
    |F| over those steps (kept on the device until the end)."""
    if corrector not in ("Langevin", "None"):
        raise NotImplementedError(f"Corrector {corrector} not supported.")
    if predictor not in ("Euler", "Reverse"):
        raise NotImplementedError(f"Predictor {predictor} not supported.")
    diff_steps = sde_rank2.N
    rev_sde = reverse_sde(sde_rank2, probability_flow)
    rev_disc = reverse_discretize(sde_rank2, probability_flow)

    @torch.no_grad()
    def sampler(score_fn, dyn: DynamicCells, init_flags: torch.Tensor,
                generator: Optional[torch.Generator], shape: Sequence[int],
                stats: Optional[dict] = None) -> torch.Tensor:
        flags, dev = init_flags, init_flags.device
        finite = torch.ones((), dtype=torch.bool, device=dev)
        finite_steps = torch.zeros((), dtype=torch.int64, device=dev)
        max_abs = torch.zeros((), device=dev)

        def noise(v):
            return gen_noise_rank2_dynamic(v, spec, dyn.member, dyn.valid, flags, generator)

        v = mask_rank2_dynamic(sde_rank2.prior_sampling(tuple(shape), generator, dev), spec,
                               dyn.member, dyn.valid, flags)
        v_mean = v
        timesteps = torch.linspace(sde_rank2.T, eps, diff_steps, device=dev)
        for i in range(diff_steps):
            vec_t = timesteps[i].expand(shape[0])
            if corrector == "Langevin":
                for _ in range(n_steps):
                    score = score_fn(v, flags, vec_t)
                    v, _ = _langevin_step(sde_rank2, score, v, noise(v), vec_t, snr,
                                          scale_eps, grad_floor=GRAD_FLOOR)
            score = score_fn(v, flags, vec_t)
            z = noise(v)
            if predictor == "Euler":
                dt = -1.0 / diff_steps
                drift, diffusion = rev_sde(v, vec_t, score)
                v_mean = v + drift * dt
                v = v_mean + _bcast(diffusion, v) * math.sqrt(-dt) * z
            else:
                f, G = rev_disc(v, vec_t, score)
                v_mean = v - f
                v = v_mean + _bcast(G, v) * z
            if stats is not None:
                finite &= v.isfinite().all()
                finite_steps += finite
                max_abs = torch.where(finite, torch.maximum(max_abs, v.abs().amax()), max_abs)
        if stats is not None:
            stats.update(finite_steps=int(finite_steps), max_abs=float(max_abs))
        return v_mean if denoise else v

    return sampler


# ------------------------------------------------------------ orchestrator --

def two_stage_sample(graph_sampler: Callable, score_fn_x: Callable, score_fn_adj: Callable,
                     rank2_sampler: Callable, f_model, sde_rank2: SDE, spec: ComplexSpec,
                     init_flags: torch.Tensor, generator: Optional[torch.Generator],
                     d_min: int, d_max: int, k_max: Optional[int] = None,
                     lifting_procedure: str = "cycles", quantize_thr: float = 0.5,
                     stats: Optional[dict] = None, **lift_kwargs):
    """Stage 1, the host bridge, stage 2 (ccsd_tpu/diffusion/two_stage.py:
    375-416).  Returns (the stage-1 ``SamplerOutput``, adj_q, rank2, dyn on
    the host, the seconds of each of stage1, bridge and stage2, the device
    synchronised at each end); ``stats`` goes to the stage-2 sampler."""
    dev = init_flags.device
    t0 = time.perf_counter()
    out = graph_sampler(score_fn_x, score_fn_adj, init_flags, generator)
    adj_q = quantize(out.adj, quantize_thr)
    adj_host = adj_q.cpu().numpy()
    t1 = time.perf_counter()
    dyn = dynamic_cells_from_adjs(adj_host, d_min, d_max, k_max, lifting_procedure,
                                  **lift_kwargs)
    t2 = time.perf_counter()
    dev_dyn = dyn.to(dev)
    shape = (adj_q.shape[0], spec.num_edges, dyn.k_max)
    score_fn = get_score_fn_rank2_dynamic(sde_rank2, f_model, dev_dyn)
    rank2 = rank2_sampler(score_fn, dev_dyn, init_flags, generator, shape, stats)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = {"stage1": t1 - t0, "bridge": t2 - t1, "stage2": time.perf_counter() - t2}
    return out, adj_q, rank2, dyn, seconds
