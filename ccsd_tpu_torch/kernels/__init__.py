"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {"gcn_aggregate": 0, "gmh_attention": 0,
                             "channel_agg": 0, "gmh_scores": 0, "gcn_degrees": 0,
                             "gmh_projection": 0,
                             "gcn_aggregate_bwd": 0, "gmh_attention_bwd": 0,
                             "gmh_score_grad": 0, "gmh_bwd_layout": 0,
                             "gmh_attention_bwd_tiled": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
