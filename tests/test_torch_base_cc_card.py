"""ScoreNetworkA_Base_CC on the card: its graph branch runs the attention
kernels (``gmh_attention`` unfused; ``channel_agg`` and ``gmh_scores``
fused), held against the plain path of the same weights on the CPU in
float64, at community_small_Base_CC's widths (N = 20, B = 2) and
grid_small_Base_CC's (N = 49, E = 1176, K = 18,424, B = 1).  The bound is
the networks' gate of chip_smoke.py: 1e-4, or 4× the CPU f32 copy's own
distance from float64 where that is larger.  Each call launches its
kernels once an AttentionLayer.

``cuda``-marked: skipped, with the reason, where there is no CUDA device.
This file imports no JAX, so it runs on the card's machine:
``python -m pytest tests/test_torch_base_cc_card.py -m cuda --noconftest``.
"""

import copy
import os

import numpy as np
import pytest
import torch

from ccsd_tpu_torch.data.loader import generated_adjs, init_features, lifted_rank2
from ccsd_tpu_torch.models.registry import load_model, load_model_params, with_fused
from ccsd_tpu_torch.ops.cells import get_spec
from ccsd_tpu_torch.ops.masks import mask_adjs, mask_rank2, mask_x
from ccsd_tpu_torch.utils.config import get_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the attention kernels run only on the card)")
    return torch.device("cuda")


def _inputs(config, B, data, seed=0):
    """B of the dataset's graphs lifted, with Gaussian noise, masked."""
    d = config.data
    N = int(d.max_node_num)
    adjs = generated_adjs(data, seed, N)[:B]
    rng = np.random.default_rng(seed)
    flags = torch.from_numpy((adjs.sum(-1) > 0).astype(np.float32))

    def noisy(a):
        return torch.from_numpy((a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32))

    adj = noisy(np.triu(adjs, 1))
    adj = mask_adjs(adj + adj.transpose(-1, -2), flags)
    x = mask_x(noisy(init_features(d.init, adjs, int(d.max_feat_num))), flags)
    spec = get_spec(N, int(d.d_min), int(d.d_max))
    return x, adj, mask_rank2(noisy(lifted_rank2(adjs, d)), spec, flags), flags


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name,data,B", [("community_small_Base_CC", "community_small_CC", 2),
                                         ("grid_small_Base_CC", "grid_small_CC", 1)])
def test_base_cc_network_on_card_matches_the_plain_path(cuda, name, data, B, fused):
    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config(name, 0, ROOT)
    d = load_model_params(cfg)[1]
    if fused:
        d = with_fused({"adj": d})["adj"]
    model = load_model(d, generator=torch.Generator().manual_seed(1)).eval()
    x, adj, rank2, flags = _inputs(cfg, B, data)
    L = int(cfg.model.num_layers)
    card = copy.deepcopy(model).to(cuda)
    reset_launches()
    with torch.no_grad():
        got = card(x.to(cuda), adj.to(cuda), rank2.to(cuda), flags.to(cuda)).cpu().double()
        launched = {k: v for k, v in LAUNCHES.items() if v}
        cpu32 = model(x, adj, rank2, flags).double()
        ref = model.double()(x.double(), adj.double(), rank2.double(), flags.double())
    want = {"channel_agg": L, "gmh_scores": L} if fused else {"gmh_attention": L}
    assert launched == want
    atol = max(1e-4, 4 * (cpu32 - ref).abs().max().item())
    assert torch.allclose(got, ref, rtol=1e-4, atol=atol), (got - ref).abs().max().item()
