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
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gossip import kernel as gkernel
from repro_torch.kernels.gossip.ops import gather_terms_kernel
from repro_torch.kernels.gossip.ref import gather_terms_ref
from repro_torch.kernels.pme_average import kernel as pkernel
from repro_torch.kernels.pme_average.ref import pme_average_ref
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

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


@pytest.mark.parametrize("lanes,m,n", [(1, 4, 64), (2, 4, 4096), (5, 7, 257), (3, 37, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pme_average_kernel_lanes(dev, lanes, m, n, dtype):
    """The lane axis: one launch over [L, m, n] equals one single-lane
    launch a lane bit for bit and the plain version's lane loop within its
    tolerance; a NaN lane leaves the other lanes bit-equal."""
    g = torch.Generator(device=dev).manual_seed(lanes * 100 + m)
    w = torch.randn((lanes, m, n), generator=g, device=dev).to(dtype)
    masks = torch.rand((lanes, m, n), generator=g, device=dev) < 0.3
    a = ((torch.rand((lanes, m, m), generator=g, device=dev) < 0.5)
         & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
    before = (pkernel.pme_average_cuda.launches, pkernel.pme_average_cuda.lane_launches)
    out = pkernel.pme_average_cuda(w, masks, a)
    torch.cuda.synchronize()
    assert (pkernel.pme_average_cuda.launches, pkernel.pme_average_cuda.lane_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = pme_average_ref(w, masks.to(dtype), a)
    for lane in range(lanes):
        one = pkernel.pme_average_cuda(w[lane], masks[lane], a[lane])
        torch.testing.assert_close(out[lane], one, rtol=0, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert _bf16_ulps(out, ref) <= 1.0
    if lanes > 1:
        w[0, 1, 3] = float("nan")
        poisoned = pkernel.pme_average_cuda(w, masks, a)
        torch.testing.assert_close(poisoned[1:], out[1:], rtol=0, atol=0)


def _ordered_ref(w, masks, a, receivers=None):
    """The kernel's sums in plain PyTorch, in its order: senders j = 0 ...
    m - 1 in turn, from 0, in f32, then an IEEE quotient.  A and the masks
    hold 0 and 1, so every product is exact and this gives the kernel's
    bits."""
    if w.dim() == 3:
        return torch.stack([_ordered_ref(*lane, receivers) for lane in zip(w, masks, a)])
    m = w.shape[0]
    r0, r = (0, m) if receivers is None else receivers
    wf, mf, af = w.float(), masks.float(), a.float()[:, r0:r0 + r]
    agg = torch.zeros((r, w.shape[1]), device=w.device)
    cnt = torch.zeros_like(agg)
    for j in range(m):
        agg = agg + af[j, :, None] * (wf[j] * mf[j])
        cnt = cnt + af[j, :, None] * mf[j]
    return torch.where(cnt > 0, agg / cnt.clamp(min=1.0), wf[r0:r0 + r]).to(w.dtype)


# coordinates enough for one ring tile (3840 at m <= 4) on each of 132 SMs
# and a partial last tile; a smaller launch takes the loop form
RING_N = 135 * 3840 + 520


def _ring_inputs(dev, m, n, dtype, mask_type, seed, lanes=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (m, n) if lanes is None else (lanes, m, n)
    w = torch.randn(shape, generator=g, device=dev).to(dtype)
    masks = torch.rand(shape, generator=g, device=dev) < 0.3
    masks = masks if mask_type == "bool" else masks.to(getattr(torch, mask_type))
    a = ((torch.rand(shape[:-2] + (m, m), generator=g, device=dev) < 0.6)
         & ~torch.eye(m, dtype=torch.bool, device=dev)).float()
    a[..., :, 1 % m] = 0  # receiver 1 isolated: its row is its own W
    return w, masks, a


@pytest.mark.parametrize("m", [2, 4, 5, 8])
@pytest.mark.parametrize("mask_type", ["bool", "uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pme_average_ring_sizes(dev, m, mask_type, dtype):
    """A launch of ring size at m = 2 and 4 (the ring form, its stage part
    filled and full) and m = 5 and 8 (the loop form), each mask type, whole
    tiles and a partial last one: equal bit for bit to the kernel's sum
    order in plain PyTorch; the isolated receiver's row is its own W.  In
    the ring, bool masks take the common pass, the others the general
    one."""
    w, masks, a = _ring_inputs(dev, m, RING_N, dtype, mask_type, seed=m)
    out = pkernel.pme_average_cuda(w, masks, a)
    torch.cuda.synchronize()
    assert torch.equal(out, _ordered_ref(w, masks, a))
    assert torch.equal(out[1 % m], w[1 % m])
    if dtype == torch.float32:
        torch.testing.assert_close(out, pme_average_ref(w, masks.to(dtype), a),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["ragged", "w-misaligned", "masks-misaligned", "lanes-ragged"])
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pme_average_ring_unaligned_rows(dev, case, m, dtype):
    """Rows a bulk copy cannot take whole: n = 512·1024 + 3 (every row's start
    but the first off 16 bytes, a ragged tail), and contiguous [m, n] views
    at an odd element offset of a larger flat buffer (W or the masks).  At
    m = 4 the ring's heads and tails come by plain loads, at m = 8 the loop
    form takes its scalar instance; the output is the kernel's sum order
    bit for bit."""
    n = 512 * 1024 + (3 if "ragged" in case else 0)
    lanes = 3 if case.startswith("lanes") else None
    w, masks, a = _ring_inputs(dev, m, n, dtype, "bool", seed=n + m, lanes=lanes)
    if case == "w-misaligned":
        buf = torch.empty(w.numel() + 8, dtype=dtype, device=dev)
        w = buf[3:3 + w.numel()].view(w.shape).copy_(w)
    if case == "masks-misaligned":
        buf = torch.empty(masks.numel() + 8, dtype=masks.dtype, device=dev)
        masks = buf[5:5 + masks.numel()].view(masks.shape).copy_(masks)
    assert w.is_contiguous() and masks.is_contiguous()
    out = pkernel.pme_average_cuda(w, masks, a)
    torch.cuda.synchronize()
    assert torch.equal(out, _ordered_ref(w, masks, a))
    assert torch.equal(out[..., 1, :], w[..., 1, :])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [RING_N, 512 * 1024 + 3])
def test_pme_average_ring_range(dev, dtype, n):
    """The receiver range r0 = 1, r = 2 of m = 4: the square launch's rows 1
    and 2 bit for bit, receiver 1 (isolated) its own W."""
    w, masks, a = _ring_inputs(dev, 4, n, dtype, "bool", seed=n)
    before = pkernel.pme_average_cuda.range_launches
    got = pkernel.pme_average_cuda(w, masks, a, receivers=(1, 2))
    square = pkernel.pme_average_cuda(w, masks, a)
    torch.cuda.synchronize()
    assert pkernel.pme_average_cuda.range_launches == before + 1
    assert got.shape == (2, n)
    assert torch.equal(got, square[1:3])
    assert torch.equal(got, _ordered_ref(w, masks, a, receivers=(1, 2)))
    assert torch.equal(got[0], w[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pme_average_ring_non_finite_w(dev, dtype):
    """NaN, +Inf and -Inf in W, at coordinates whose mask is 1 and at
    coordinates whose mask is 0, in a launch of ring size with bool masks
    and a 0/1 selection (the common pass, which hands a group holding one to
    the general pass): the output is the kernel's sum order in plain
    PyTorch, NaN where it is NaN.  A masked-out NaN or Inf still reaches
    every receiver that hears any sender there, through 0 * NaN, as IEEE
    has it."""
    m = 4
    w, masks, a = _ring_inputs(dev, m, RING_N, dtype, "bool", seed=17)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
    cols = torch.arange(0, RING_N, 4093, device=dev)  # spread over the tiles
    rows = cols % m
    w[rows, cols] = specials[torch.arange(cols.numel(), device=dev) % 3].to(dtype)
    masks[rows, cols] = torch.arange(cols.numel(), device=dev) % 2 == 0  # 1, 0, 1, ...
    out = pkernel.pme_average_cuda(w, masks, a)
    torch.cuda.synchronize()
    want = _ordered_ref(w, masks, a)
    assert torch.isnan(want).any() and torch.isinf(want).any()
    torch.testing.assert_close(out, want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(out[1], w[1], rtol=0, atol=0, equal_nan=True)


def test_pme_average_quotient_equals_ieee_division(dev):
    """The kernel's branch-free quotient agg / d (Markstein's correction of
    agg * RN(1/d)) against IEEE division, for every float dividend (all 2^32
    bit patterns) and d = 1 ... 8: bit for bit wherever the kernel takes it
    (agg 0 or of magnitude 2^-100 ... 2^100)."""
    import ctypes

    from repro_torch.kernels import _build

    out = torch.zeros(2, dtype=torch.int64, device=dev)
    fn = _build.load("pme_average").pme_average_quotient_check
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    assert fn(out.data_ptr()) == 0
    wrong, compared = out.tolist()
    assert wrong == 0
    # each sign: 200 binades of 2^23 significands and 2^100 itself; 0, -0
    assert compared == 8 * (2 * (200 * 2 ** 23 + 1) + 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes,m,n", [(2, 4, 4096), (5, 9, 257), (3, 40, 130)])
def test_gossip_kernel_folded_lanes(dev, dtype, lanes, m, n):
    """Design (a): the lane-offset [L·m, k] table (`fold_padded`) is one
    launch, bit-equal to one launch a lane (f32: the slots chain; bf16: the
    f32 chain rounded once), and a NaN lane reaches no other lane."""
    topo = build_topology("erdos_renyi", m, p=0.5, seed=1)
    pm = mixing.make_mixer(topo, "sparse", device=dev).pm
    folded = mixing.fold_padded(pm, lanes)
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((lanes * m, n), generator=g, device=dev).to(dtype)
    before = gkernel.gossip_gather.launches
    (got,) = gather_terms_kernel(folded.nbrs, [(folded.w, x)], pad=folded.pad)
    torch.cuda.synchronize()
    assert gkernel.gossip_gather.launches == before + 1
    for lane, xl in enumerate(x.chunk(lanes)):
        (one,) = gather_terms_kernel(pm.nbrs, [(pm.w, xl)], pad=pm.pad)
        torch.testing.assert_close(got[lane * m:(lane + 1) * m], one, rtol=0, atol=0)
        (slots,) = mixing.gather_terms(pm.nbrs, [(pm.w, xl.float())], impl="slots")
        torch.testing.assert_close(one, slots.to(dtype), rtol=0, atol=0)
    x[1] = float("nan")  # lane 0, node 1
    (poisoned,) = gather_terms_kernel(folded.nbrs, [(folded.w, x)], pad=folded.pad)
    torch.testing.assert_close(poisoned[m:], got[m:], rtol=0, atol=0)


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


@pytest.mark.parametrize("m,n,kind", [(7, 257, "erdos_renyi"), (9, 1000, "star"),
                                      (40, 130, "ring"), (4, 4096, "erdos_renyi"),
                                      (4, 8 * 1000 + 3, "erdos_renyi")])
def test_gossip_kernel_bf16_equals_f32_slots_rounded(dev, m, n, kind):
    """bf16 operands: f32 sums in slot order, rounded once — the f32 slots
    chain on x.float() rounded to bf16, bit for bit (n % 8 != 0 takes the
    scalar instance)."""
    topo = build_topology(kind, m, **({"p": 0.5, "seed": 1} if kind == "erdos_renyi" else {}))
    nbrs, w, is_self = (torch.as_tensor(x, device=dev) for x in topo.mixing_padded())
    pad = (nbrs == torch.arange(m, device=dev)[:, None]) & ~is_self
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn((m, n), generator=g, device=dev).to(torch.bfloat16)
    poisoned = torch.where(pad, torch.full_like(w, float("nan")), w)
    before = dict(gkernel.gossip_gather.variant_launches)
    got = gather_terms_kernel(nbrs, [(poisoned, x)], pad=pad)[0]
    torch.cuda.synchronize()
    assert gkernel.gossip_gather.variant_launches["bf16"] == before["bf16"] + 1
    assert gkernel.gossip_gather.variant_launches["f32"] == before["f32"]
    want = mixing.gather_terms(nbrs, [(w, x.float())], impl="slots")[0].to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,n", [(5, 3, 4104), (4, 3, 3 * 4096 + 7)])
def test_mix_replicated_through_the_kernel(dev, dtype, m, d, n):
    """The per-receiver replica mix of the fault steps: one launch over a
    held leaf [m, d + 1, n] read in place as m·(d + 1) sender rows
    (replicas, then each receiver's own row), equal to the f32 slots chain
    over the d + 1 slots rounded once; path E's graph (m = 4, d = 3) with
    a zero-weight padding replica among the cases."""
    g = torch.Generator(device=dev).manual_seed(d * n)
    w_off = torch.rand((m, d), generator=g, device=dev) * 0.3
    w_off[-1, -1] = 0.0
    self_w = 1.0 - w_off.sum(dim=1)
    held = torch.randn((m, d + 1, n), generator=g, device=dev).to(dtype)
    before = dict(gkernel.gossip_gather.variant_launches)
    got = mixing.mix_replicated(w_off, self_w, held)
    torch.cuda.synchronize()
    variant = "f32" if dtype == torch.float32 else "bf16"
    assert gkernel.gossip_gather.variant_launches[variant] == before[variant] + 1
    table = mixing.replica_table(m, d, dev)
    w = torch.cat([w_off, self_w[:, None]], dim=1)
    want = mixing.gather_terms(table, [(w, held.view(m * (d + 1), n).float())],
                               impl="slots")[0].to(dtype)
    assert got.shape == (m, n) and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gossip_kernel_refuses_other_types(dev):
    nbrs = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    ws = torch.ones((1, 2, 1), device=dev)
    with pytest.raises(TypeError, match="unsupported operand type"):
        gkernel.gossip_gather(nbrs, ws, [torch.zeros((2, 4), dtype=torch.float16, device=dev)], (0,))
    with pytest.raises(TypeError, match="one type"):
        gkernel.gossip_gather(nbrs, ws, [torch.zeros((2, 4), device=dev),
                                         torch.zeros((2, 4), dtype=torch.bfloat16, device=dev)],
                              (0, 0))


def test_baseline_mixer_runs_bf16_kernel(dev, monkeypatch):
    """A bound baseline's sparse Mixer on a bf16 tree: one bf16 launch per
    leaf, equal to the f32 slots chain rounded once."""
    monkeypatch.delenv(mixing.ENV_VAR, raising=False)
    mx = mixing.make_mixer(build_topology("erdos_renyi", 4, p=0.5, seed=0), "sparse", device=dev)
    tree = {"a": torch.randn((4, 64, 33), device=dev).to(torch.bfloat16),
            "b": torch.randn((4, 5), device=dev).to(torch.bfloat16)}
    before = gkernel.gossip_gather.variant_launches["bf16"]
    out = mx.mix(tree)
    torch.cuda.synchronize()
    assert gkernel.gossip_gather.variant_launches["bf16"] == before + 2
    for key, x in tree.items():
        want = mixing.gather_terms(mx.pm.nbrs, [(mx.pm.w, x.float())], pad=mx.pm.pad,
                                   impl="slots")[0].to(torch.bfloat16)
        torch.testing.assert_close(out[key], want, rtol=0, atol=0)


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


def _bf16_ulps_floored(got, want):
    """|got - want| in bf16 ulps of max(|want|, max|want| / 256): below
    1/256 of the output's scale, f32 sums taken in another order differ by
    more than an ulp of the tiny value itself."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


FLASH_CASES = [
    (2, 64, 4, 2, 16, None), (1, 128, 4, 4, 32, None), (2, 64, 4, 2, 16, 24),
    (1, 64, 8, 1, 64, None), (1, 32, 2, 2, 8, 5),   # tests/test_kernels.py's sweep
    (2, 300, 4, 2, 64, None), (1, 200, 4, 4, 128, 70), (1, 64, 2, 1, 256, None),
]


@pytest.mark.parametrize("b,s,h,kv,d,win", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(dev, b, s, h, kv, d, win, dtype):
    g = torch.Generator(device=dev).manual_seed(s + h + d)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = fkernel.flash_attention_cuda.launches
    out = fkernel.flash_attention_cuda(q, k, v, window=win)
    torch.cuda.synchronize()
    assert fkernel.flash_attention_cuda.launches == before + 1
    want = attention_ref(q.float(), k.float(), v.float(), win)
    assert out.dtype == dtype and torch.isfinite(out).all()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * max(1.0, want.abs().max().item()))
    else:
        assert _bf16_ulps_floored(out, want) <= 1.0


SSD_CASES = [(2, 3, 16, 4, 8, 2, 8), (1, 2, 32, 2, 16, 1, 4), (1, 1, 8, 8, 4, 4, 16),
             (2, 3, 128, 4, 64, 1, 64), (1, 2, 37, 3, 12, 3, 20), (1, 1, 128, 2, 64, 1, 128)]


@pytest.mark.parametrize("b,nc,l,h,p,g,n", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_chunk_kernel(dev, b, nc, l, h, p, g, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(b * 100 + l)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    xc = rnd(b, nc, l, h, p).to(dtype)
    dtc = torch.rand((b, nc, l, h), generator=gen, device=dev) * 0.2 + 0.01
    a = -torch.exp(rnd(h) * 0.2)
    cum = torch.cumsum(dtc * a, dim=2)
    bc, cc = rnd(b, nc, l, g, n).to(dtype), rnd(b, nc, l, g, n).to(dtype)
    before = skernel.ssd_intra_chunk_cuda.launches
    y, st = skernel.ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, h // g)
    torch.cuda.synchronize()
    assert skernel.ssd_intra_chunk_cuda.launches == before + 1
    y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), h // g)
    assert y.dtype == dtype and st.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    scale = max(1.0, st_r.abs().max().item())
    torch.testing.assert_close(st, st_r, rtol=0, atol=1e-5 * scale)
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_r, rtol=0, atol=1e-5 * max(1.0, y_r.abs().max().item()))
    else:
        assert _bf16_ulps_floored(y, y_r) <= 1.0


# the tensor-core variants: D = 64 and 128, S not a multiple of the 128-row
# query tile or of a key tile, a window inside one tile, qwen3's 40/8 GQA;
# then one query row, one key past a 64-key tile, a window longer than S,
# 20/4 GQA at D = 128 and three batch rows of a ragged S (the TMA tensor
# maps' zero fill and their head and batch coordinates)
TC_FLASH_CASES = [
    (2, 256, 4, 2, 64, None), (1, 256, 2, 2, 128, None), (2, 100, 4, 2, 64, None),
    (1, 1000, 2, 1, 64, None), (1, 1000, 2, 2, 128, 37), (1, 300, 4, 4, 64, 5),
    (1, 200, 40, 8, 128, None), (1, 130, 40, 8, 64, 70),
    (1, 1, 2, 1, 64, None), (1, 65, 4, 2, 128, None), (1, 300, 4, 2, 64, 1000),
    (1, 257, 20, 4, 128, None), (3, 333, 4, 1, 64, None),
]


@pytest.mark.parametrize("b,s,h,kv,d,win", TC_FLASH_CASES)
def test_flash_attention_tensor_core_variant(dev, b, s, h, kv, d, win):
    g = torch.Generator(device=dev).manual_seed(s + h + d + (win or 0))
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    assert fkernel.flash_variant(q.dtype, d) == "tensor_cores"
    before = fkernel.flash_attention_cuda.variant_launches["tensor_cores"]
    out = fkernel.flash_attention_cuda(q, k, v, window=win)
    torch.cuda.synchronize()
    assert fkernel.flash_attention_cuda.variant_launches["tensor_cores"] == before + 1
    want = attention_ref(q.float(), k.float(), v.float(), win)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _bf16_ulps_floored(out, want) <= 1.0


# the tensor-core variant: L = 128 with N = 64 and 128, chunks shorter than
# 128, G > 1, P = 128; then fewer work items than SMs, rep = 3 with two
# heads a work item (a block of two and one of one), rep = 2 on three
# groups, 40 heads in blocks of 32 and 8, L = 16 with N = 16 (64-row tiles
# mostly past L), L = 112 with N = 128, and P = N = 128
TC_SSD_CASES = [(2, 3, 128, 4, 64, 1, 64), (1, 2, 128, 4, 64, 1, 128), (1, 3, 64, 4, 64, 1, 64),
                (2, 2, 48, 6, 32, 3, 16), (1, 2, 128, 8, 32, 2, 32), (1, 1, 112, 4, 128, 2, 48),
                (1, 1, 128, 4, 64, 1, 64), (2, 40, 128, 3, 64, 1, 64), (1, 70, 64, 6, 64, 3, 64),
                (2, 40, 128, 40, 64, 1, 64), (1, 2, 16, 4, 32, 1, 16), (2, 3, 112, 8, 64, 1, 128),
                (1, 2, 128, 4, 128, 1, 128)]


def _ssd_inputs(dev, b, nc, l, h, p, g, n, rate=None):
    """bf16 x, B, C and f32 dt in [0.01, 0.21); cum the chunk's running sum
    of dt times a negative rate a head (exp(0.2 z), or `rate`)."""
    gen = torch.Generator(device=dev).manual_seed(b * 100 + l + n)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    xc = rnd(b, nc, l, h, p).to(torch.bfloat16)
    dtc = torch.rand((b, nc, l, h), generator=gen, device=dev) * 0.2 + 0.01
    a = -torch.exp(rnd(h) * 0.2) if rate is None else torch.full((h,), -rate, device=dev)
    cum = torch.cumsum(dtc * a, dim=2)
    bc, cc = rnd(b, nc, l, g, n).to(torch.bfloat16), rnd(b, nc, l, g, n).to(torch.bfloat16)
    return xc, dtc, cum, bc, cc


@pytest.mark.parametrize("b,nc,l,h,p,g,n", TC_SSD_CASES)
def test_ssd_intra_chunk_tensor_core_variant(dev, b, nc, l, h, p, g, n):
    xc, dtc, cum, bc, cc = _ssd_inputs(dev, b, nc, l, h, p, g, n)
    assert skernel.ssd_variant(xc.dtype, l, p, n) == "tensor_cores"
    before = skernel.ssd_intra_chunk_cuda.variant_launches["tensor_cores"]
    y, st = skernel.ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, h // g)
    torch.cuda.synchronize()
    assert skernel.ssd_intra_chunk_cuda.variant_launches["tensor_cores"] == before + 1
    y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), h // g)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(st, st_r, rtol=0, atol=1e-5 * max(1.0, st_r.abs().max().item()))
    assert _bf16_ulps_floored(y, y_r) <= 1.0


@pytest.mark.parametrize("b,nc,l,h,p,g,n", [(1, 2, 128, 4, 64, 1, 64), (1, 2, 112, 6, 64, 3, 128),
                                            (2, 40, 128, 40, 64, 1, 64)])
def test_ssd_intra_chunk_tensor_core_variant_steep_decay(dev, b, nc, l, h, p, g, n):
    """cum falls by more than 88 inside a chunk, so above the diagonal
    exp(cum_i - cum_j) overflows f32: the kernel must mask it, not multiply
    it by 0 (NaN); y and the state stay finite and within the tolerances."""
    xc, dtc, cum, bc, cc = _ssd_inputs(dev, b, nc, l, h, p, g, n, rate=10.0)
    assert (cum[:, :, 0] - cum[:, :, -1]).min().item() > 88.0
    y, st = skernel.ssd_intra_chunk_cuda(xc, dtc, cum, bc, cc, h // g)
    torch.cuda.synchronize()
    y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), h // g)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(st, st_r, rtol=0, atol=1e-5 * max(1.0, st_r.abs().max().item()))
    assert _bf16_ulps_floored(y, y_r) <= 1.0


def test_model_kernel_routes_launch_once_per_site(dev):
    """zamba2 at a small width on the card, in f32: one flash launch per
    shared-block site and one SSD launch per Mamba2 layer in a prefill,
    none in a decode step; logits within 1e-4 (relative) of the plain
    route (both f32; the kernels sum in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config("zamba2-1.2b", "smoke").replace(n_layers=5)
    params = init_params(0, cfg, device=dev)
    tok = torch.randint(0, cfg.vocab, (2, 64), device=dev)
    f0, s0 = fkernel.flash_attention_cuda.launches, skernel.ssd_intra_chunk_cuda.launches
    with torch.inference_mode():
        kcfg = cfg.replace(use_flash=True, use_ssd_kernel=True)
        lk, caches = prefill(params, kcfg, {"tokens": tok}, 70)
        assert fkernel.flash_attention_cuda.launches - f0 == 3  # 5 layers, attn_every 2
        assert skernel.ssd_intra_chunk_cuda.launches - s0 == 5
        decode_step(params, kcfg, lk.argmax(-1), 64, caches)
        assert fkernel.flash_attention_cuda.launches - f0 == 3
        lp, _ = prefill(params, cfg, {"tokens": tok}, 70)
    assert torch.isfinite(lk).all()
    assert ((lk - lp).norm() / lp.norm()).item() <= 1e-4


# ---------------------------------------------------------------------------
# same seed, same bits on the card (tests/test_torch_determinism.py's
# counterparts), and folded network lanes through the kernels
# ---------------------------------------------------------------------------
def _cnn_task(dev, m=4, per_node=8):
    from repro_torch.models import cnn
    from repro_torch.tree import tree_flatten, tree_unflatten

    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"x": torch.randn((m, per_node, 28, 28, 1), generator=g, device=dev),
             "y": torch.randint(0, 10, (m, per_node), generator=g, device=dev,
                                dtype=torch.int32)}

    def grad_fn(params, b, key):
        leaves, td = tree_flatten(params)
        loss = cnn.ce_loss(cnn.cnn_apply(params, b["x"]), b["y"])
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    return batch, grad_fn


def test_cnn_training_repeats_bit_for_bit(dev):
    """PaME on the CNN (dense exact exchange: the PME-average kernel) and
    D-PSGD (gossip kernel), each run twice from one seed with no switch
    set by the caller: equal parameters, leaf for leaf."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology, run_pame
    from repro_torch.core.pame import PaMEConfig
    from repro_torch.models import cnn
    from repro_torch.tree import tree_leaves

    batch, grad_fn = _cnn_task(dev)
    topo = build_topology("complete", 4)
    cfg = PaMEConfig(nu=0.5, p=0.3, gamma=1.01, sigma0=4.0)
    runs = (lambda: run_pame(0, cnn.cnn_init(1, device=dev), 4, grad_fn, lambda k: batch,
                             topo, cfg, num_steps=4, tol_std=0.0, device=dev)[0].params,
            lambda: ALG.get_algorithm("dpsgd").bind(grad_fn, topo, ALG.DPSGDHp(lr=0.05),
                                                    device=dev).run(
                0, cnn.cnn_init(1, device=dev), 4, lambda k: batch, 4, tol_std=0.0)[0].params)
    for run in runs:
        a, b = run(), run()
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.backends.cudnn.deterministic
    assert not torch.are_deterministic_algorithms_enabled()


def test_moe_and_embedding_backward_repeat(dev):
    """The MoE layer's forward and backward, and the token embedding's
    backward, twice on the same inputs: bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("deepseek-v2-lite-16b", "smoke").replace(capacity_factor=0.5)
    from repro_torch.tree import tree_map

    params = tree_map(lambda v: v.to(dev),
                      moe.moe_init(torch.Generator().manual_seed(3), cfg, torch.float32))
    x = torch.randn((4, 64, cfg.d_model), device=dev)
    w = torch.randn(x.shape, device=dev)
    emb = torch.randn((1000, 256), device=dev)
    tok = torch.randint(0, 50, (8, 512), device=dev)  # many repeats of each row

    def once():
        from repro_torch.tree import tree_flatten, tree_unflatten

        leaves, td = tree_flatten(params)
        leaves = [v.clone().requires_grad_(True) for v in leaves]
        xt = x.clone().requires_grad_(True)
        y, _ = moe.moe_apply(tree_unflatten(td, leaves), cfg, xt)
        g = torch.autograd.grad(torch.sum(y * w), leaves + [xt])
        e = emb.clone().requires_grad_(True)
        (ge,) = torch.autograd.grad(torch.sum(e[tok] * torch.arange(256.0, device=dev)), [e])
        return [y.detach(), *g, ge]

    a, b = once(), once()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("form", ["scenario", "temporal", "faults", "paced"])
def test_folded_network_lanes_equal_unbatched(dev, form):
    """A lane-batched step under each network form, on the card through the
    gossip kernel, equals each lane's unbatched step bit for bit; one
    exchange launch a leaf for all lanes."""
    from repro_torch.core import algorithms as ALG
    from repro_torch.core import build_topology
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.pme import fold_in
    from repro_torch.core.scenarios import Scenario
    from repro_torch.core.temporal import TemporalScenario
    from repro_torch.models import cnn
    from repro_torch.serve.events import ArrivalProcess, ServePacing
    from repro_torch.tree import tree_leaves

    name, kw = {
        "scenario": ("pame", dict(scenario=Scenario(name="f", churn=0.1, edge_drop=0.2, seed=5))),
        "temporal": ("pame", dict(scenario=TemporalScenario(name="t", straggler=0.4,
                                                            staleness=2, seed=4))),
        "faults": ("choco", dict(faults=FaultModel(name="l", loss=0.2, crash=0.1, seed=3))),
        "paced": ("dpsgd", dict(pacing=ServePacing(ArrivalProcess(
            name="b", rate=0.5, burst_rate=6.0), capacity=2, defer_threshold=3))),
    }[form]
    hp = {"pame": ALG.PaMEHp(nu=0.5, p=0.3), "choco": ALG.ChocoHp(),
          "dpsgd": ALG.DPSGDHp()}[name]
    batch, grad_fn = _cnn_task(dev)
    topo = build_topology("erdos_renyi", 4, p=0.7, seed=1)
    seeds = [0, 1, 2]
    alg = ALG.get_algorithm(name)
    ba = alg.bind_batched(grad_fn, topo, [hp], seeds=seeds, device=dev, **kw)
    state = ba.init(cnn.cnn_init(1, device=dev), 4, batch)
    aux = ba.aux_init(state) if ba.carries_aux else None
    before = dict(gkernel.gossip_gather.variant_launches)
    for k in range(3):
        if ba.carries_aux:
            state, _, aux = ba.step(state, batch, k, aux)
        else:
            state, _ = ba.step(state, batch, k)
    torch.cuda.synchronize()
    launched = gkernel.gossip_gather.variant_launches["f32"] - before["f32"]
    assert launched == 3 * len(tree_leaves(cnn.cnn_init(1)))
    for lane, s in enumerate(seeds):
        b = alg.bind(grad_fn, topo, hp, device=dev, **kw)
        b.scen_arrays = b.scen_arrays._replace(key=fold_in(b.scen_arrays.key, s))
        if b.faulty:
            b.fault_key = fold_in(int(b.faults.seed), s)
        if b.paced:
            b.pace_key = fold_in(int(b.pacing.process.seed), s)
        st = b.init(s, ALG.B.stack_params(cnn.cnn_init(1, device=dev), 4), batch)
        ax = b.aux_init(st) if b.carries_aux else None
        for k in range(3):
            if b.carries_aux:
                st, _, ax = b.step(st, batch, k, ax)
            else:
                st, _ = b.step(st, batch, k)
        for got, want in zip(tree_leaves(ba.params_of(state)), tree_leaves(b.params_of(st))):
            assert torch.equal(got[lane], want), (form, lane)
