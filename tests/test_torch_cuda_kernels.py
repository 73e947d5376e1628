"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip (with the reason) where no card is present, and
run on the H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import mixing, pme
from repro_torch.core.topology import build_topology
from repro_torch.kernels.gossip import kernel as gkernel
from repro_torch.kernels.gossip.ops import gather_terms_kernel
from repro_torch.kernels.gossip.ref import gather_terms_ref
from repro_torch.kernels.pme_average import kernel as pkernel
from repro_torch.kernels.pme_average.ref import pme_average_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulps(got, want):
    """|got - want| in units of one bf16 ulp of want."""
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126))) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


@pytest.mark.parametrize("m,n", [(4, 64), (7, 257), (37, 130), (16, 4096), (3, 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_as", ["bool", "w"])
def test_pme_average_kernel(dev, m, n, dtype, mask_as):
    g = torch.Generator(device=dev).manual_seed(m * 1000 + n)
    w = torch.randn((m, n), generator=g, device=dev).to(dtype)
    masks = torch.rand((m, n), generator=g, device=dev) < 0.3
    a = ((torch.rand((m, m), generator=g, device=dev) < 0.5)
         & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
    a[:, 0] = 0  # receiver 0 isolated: falls back to its own row
    before = pkernel.pme_average_cuda.launches
    out = pkernel.pme_average_cuda(w, masks if mask_as == "bool" else masks.to(dtype), a)
    torch.cuda.synchronize()
    assert pkernel.pme_average_cuda.launches == before + 1
    ref = pme_average_ref(w, masks.to(dtype), a)
    assert out.dtype == dtype
    torch.testing.assert_close(out[0], w[0], rtol=0, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert _bf16_ulps(out, ref) <= 1.0


@pytest.mark.parametrize("m,n,kind", [(7, 257, "erdos_renyi"), (9, 1024, "star"),
                                      (40, 130, "ring"), (4, 4096, "erdos_renyi")])
def test_gossip_kernel_equals_slots(dev, m, n, kind):
    topo = build_topology(kind, m, **({"p": 0.5, "seed": 1} if kind == "erdos_renyi" else {}))
    nbrs, w, is_self = (torch.as_tensor(x, device=dev) for x in topo.mixing_padded())
    pad = (nbrs == torch.arange(m, device=dev)[:, None]) & ~is_self
    g = torch.Generator(device=dev).manual_seed(n)
    xs = [torch.randn((m, n), generator=g, device=dev) for _ in range(2)]
    poisoned = torch.where(pad, torch.full_like(w, float("nan")), w)
    before = gkernel.gossip_gather.launches
    got = gather_terms_kernel(nbrs, [(poisoned, xs[0]), (poisoned, xs[1])], pad=pad)
    torch.cuda.synchronize()
    assert gkernel.gossip_gather.launches == before + 1  # one launch, shared table
    slots = mixing.gather_terms(nbrs, [(w, xs[0]), (w, xs[1])], impl="slots")
    ref = gather_terms_ref(nbrs, [(w, xs[0]), (w, xs[1])])
    for o, s, r in zip(got, slots, ref):
        assert torch.isfinite(o).all()
        torch.testing.assert_close(o, s, rtol=0, atol=0)  # the slots arithmetic
        torch.testing.assert_close(o, r, rtol=1e-6, atol=1e-6)


def test_pme_route_uses_kernel_on_cuda(dev, monkeypatch):
    monkeypatch.delenv(mixing.ENV_VAR, raising=False)
    m = 4
    a = torch.ones((m, m), device=dev) - torch.eye(m, device=dev)
    params = {"big": torch.randn((m, 1 << 16), device=dev),
              "small": torch.randn((m, 8), device=dev)}
    before = pkernel.pme_average_cuda.launches
    out = pme.pme_average_pytree(0, params, a, 0.3, mode="exact")
    assert pkernel.pme_average_cuda.launches == before + 1  # only the big leaf
    monkeypatch.setenv(mixing.ENV_VAR, "slots")
    plain = pme.pme_average_pytree(0, params, a, 0.3, mode="exact")
    assert pkernel.pme_average_cuda.launches == before + 1
    torch.testing.assert_close(out["big"], plain["big"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(out["small"], plain["small"], rtol=0, atol=0)
