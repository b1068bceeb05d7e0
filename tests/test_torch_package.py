"""Package boundaries of the port and its on-card kernel checks.

* Nothing in ccsd_tpu_torch/ or chip_smoke.py imports jax, jaxlib, optax,
  flax or ccsd_tpu (an AST walk), and every module imports in a process
  where those cannot be imported.
* Entry points default to CUDA and raise without it.
* Tests marked ``cuda`` run each kernel against its plain version on the
  card; they skip where there is no CUDA device (decided inside the test).
  This file imports no JAX, so they run on a machine without it.
"""

import ast
import math
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import ccsd_tpu_torch
from ccsd_tpu_torch import default_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ccsd_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "ccsd_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        ccsd_tpu_torch.__path__, "ccsd_tpu_torch."))


def test_import_guard_covers_every_kernel_module():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    assert {"chip_smoke.py", "ccsd_tpu_torch/kernels/channel_agg.py",
            "ccsd_tpu_torch/kernels/gmh_scores.py"} <= rel


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert {"ccsd_tpu_torch.sampling.sampler", "ccsd_tpu_torch.kernels.channel_agg",
            "ccsd_tpu_torch.kernels.gmh_scores"} <= set(mods)
    script = (
        "import importlib, sys\n"
        f"for m in {FORBIDDEN!r}:\n    sys.modules[m] = None\n"
        f"for m in {mods!r}:\n    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    from ccsd_tpu_torch.sampling.sampler import Sampler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Sampler({"data": {}}, np.zeros((1, 4, 4)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")


def test_kernels_raise_for_wrong_inputs_before_any_build():
    from ccsd_tpu_torch.kernels.gcn import check_cuda_f32

    meta = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="expected CUDA"):
        check_cuda_f32("k", x=meta)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 20, 11, 32), (128, 20, 32, 32), (3, 64, 128, 128)])
def test_gcn_kernel_matches_plain_on_card(cuda, shape):
    from ccsd_tpu_torch.kernels.gcn import gcn_aggregate, gcn_aggregate_plain

    B, N, Fi, Fo = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(B, N, Fi, device=cuda, generator=g)
    adj = (torch.rand(B, N, N, device=cuda, generator=g) > 0.7).float()
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(1, 2)
    w = torch.randn(Fi, Fo, device=cuda, generator=g)
    b = torch.randn(Fo, device=cuda, generator=g)
    for loop in (1.0, 2.0):
        out = gcn_aggregate(x, adj, w, b, loop)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, gcn_aggregate_plain(x, adj, w, b, loop),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C,Fi", [(2, 11), (8, 32)])
def test_gmh_kernel_matches_plain_on_card(cuda, C, Fi):
    from ccsd_tpu_torch.kernels.gmh_attention import gmh_attention, gmh_attention_plain

    B, N, A, O, H = 128, 20, 32, 32, 4
    g = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s: torch.randn(*s, device=cuda, generator=g)  # noqa: E731
    x = r(B, N, Fi)
    adj = torch.rand(B, C, N, N, device=cuda, generator=g)
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(-1, -2)
    w = [r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, A) * 0.3, r(C, A), r(C, Fi, O), r(C, O)]
    out = gmh_attention(x, adj, *w, H, O)
    torch.cuda.synchronize()
    ref = gmh_attention_plain(x, adj, *w, H, O)
    for o, rr in zip(out, ref):
        torch.testing.assert_close(o, rr, rtol=1e-5, atol=1e-5)


def _bf16_ulp(v: float) -> float:
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(v))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("C,F", [(2, 11), (8, 32)])
def test_channel_agg_kernel_matches_plain_on_card(cuda, C, F):
    from ccsd_tpu_torch.kernels import LAUNCHES
    from ccsd_tpu_torch.kernels.channel_agg import channel_agg, channel_agg_plain

    B, N = 128, 20
    g = torch.Generator(device=cuda).manual_seed(0)
    norm = torch.rand(B, C, N, N, device=cuda, generator=g)
    x = torch.randn(B, N, F, device=cuda, generator=g)
    before = LAUNCHES["channel_agg"]
    out = channel_agg(norm, x)
    folded = channel_agg(norm.view(B, C * N, N), x)  # the probes' folded form
    torch.cuda.synchronize()
    assert LAUNCHES["channel_agg"] == before + 2
    ref = channel_agg_plain(norm, x)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(folded.view(B, C, N, F), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 8])
@pytest.mark.parametrize("bf16", [False, True])
def test_gmh_scores_kernel_matches_plain_on_card(cuda, C, bf16):
    """Q and K as the fused layer hands them over: strided column blocks of
    one (C, B, N, 2A + O) projection.  bf16: both sides round each head sum
    to bf16 once, but their f32 sums may round to the two neighbours of the
    exact sum, one bf16 ulp of |s| apart, which tanh (slope <= 1) and the
    1/sqrt(O) scale carry to the map."""
    from ccsd_tpu_torch.kernels.gmh_scores import gmh_scores, gmh_scores_plain

    B, N, A, H, O = 128, 20, 32, 4, 32
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(C, B, N, 2 * A + O, device=cuda, generator=g).transpose(0, 1)
    q, k = qkv[..., :A], qkv[..., A:2 * A]
    out = gmh_scores(q, k, H, O, bf16=bf16)
    torch.cuda.synchronize()
    ref = gmh_scores_plain(q, k, H, O, bf16=bf16)
    tol = 1e-5
    if bf16:
        s = torch.einsum("bcnhd,bcmhd->bchnm", q.reshape(B, C, N, H, -1),
                         k.reshape(B, C, N, H, -1))
        tol += _bf16_ulp(s.abs().max().item()) / math.sqrt(O)
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("conv", ["GCN", "MLP"])
def test_fused_attention_layer_on_card_matches_cpu(cuda, conv):
    """The fused layer hands its kernels strided Q and K views.  f32 scores,
    against a float64 CPU copy: the card's f32 rounding only (rtol = atol =
    1e-5); float64 because f32 CPU results were seen to move between
    processes on the card's machine (chip_smoke.py, MODEL_TOL)."""
    import copy

    from ccsd_tpu_torch.kernels import LAUNCHES, reset_launches
    from ccsd_tpu_torch.models.attention import AttentionLayer

    g = torch.Generator().manual_seed(2)
    layer = AttentionLayer(2, 32, 32, 32, 8, 8, conv=conv, fused=True, generator=g).eval()
    B, N = 128, 20
    x = torch.randn(B, N, 32, generator=g)
    adj = torch.rand(B, 8, N, N, generator=g)
    adj = torch.triu(adj, 1)
    adj = adj + adj.transpose(-1, -2)
    flags = torch.ones(B, N)
    flags[:, 15:] = 0
    card = copy.deepcopy(layer).to(cuda)
    reset_launches()
    with torch.no_grad():
        got = card(x.to(cuda), adj.to(cuda), flags.to(cuda))
        torch.cuda.synchronize()
        ref = layer.double()(x.double(), adj.double(), flags.double())
    assert LAUNCHES["channel_agg"] == 1 and LAUNCHES["gmh_scores"] == 1
    for o, r in zip(got, ref):
        torch.testing.assert_close(o.cpu().double(), r, rtol=1e-5, atol=1e-5)
