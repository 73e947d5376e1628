"""The port's plain kernel versions against the JAX kernels (Pallas in
interpret mode on the CPU), and the CPU dispatch of the port's wrappers.

Tolerances are those of the JAX kernel tests: PME average f32 atol 1e-5,
bf16 5e-2; gossip 1e-5; flash attention 2e-5 f32, 2e-2 bf16; SSD 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_topology as jbuild
from repro.core.mixing import gather_terms as jgather, make_mixer
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.gossip.ops import gather_terms_pallas
from repro.kernels.pme_average.ops import pme_average as jpme_average
from repro.kernels.ssd_scan.ops import ssd_intra_chunk as jssd_intra_chunk
from repro_torch.core import mixing as tmix
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gossip import kernel as gkernel
from repro_torch.kernels.gossip.ops import gather_terms_kernel
from repro_torch.kernels.gossip.ref import gather_terms_ref
from repro_torch.kernels.pme_average import kernel as pkernel
from repro_torch.kernels.pme_average.ops import pme_average
from repro_torch.kernels.pme_average.ref import pme_average_ref
from repro_torch.kernels.ssd_scan import kernel as skernel
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref

from _torch_parity import to_np, to_t

ATOL = 1e-5


def _pme_inputs(m, n, dtype, seed, p_mask=0.3):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((m, n)), dtype)
    masks = rng.random((m, n)) < p_mask
    a = ((rng.random((m, m)) < 0.5) & ~np.eye(m, dtype=bool)).astype(np.float32)
    return w, masks, a


@pytest.mark.parametrize("m,n", [(4, 64), (8, 100), (16, 700), (3, 17), (7, 257), (37, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pme_average_plain_matches_jax_kernel(m, n, dtype):
    w, masks, a = _pme_inputs(m, n, getattr(jnp, dtype), m * 1000 + n)
    want = jpme_average(w, jnp.asarray(masks), jnp.asarray(a), block_n=128)
    tw = to_t(w)
    got = pme_average_ref(tw, torch.as_tensor(masks).to(tw.dtype), torch.as_tensor(a))
    assert got.dtype == tw.dtype
    tol = ATOL if dtype == "float32" else 5e-2
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=tol)


def test_pme_average_ops_on_cpu_takes_plain_version():
    w, masks, a = _pme_inputs(6, 50, jnp.float32, 1)
    before = pkernel.pme_average_cuda.launches
    tw, tm, ta = to_t(w), torch.as_tensor(masks), torch.as_tensor(a)
    out = pme_average(tw, tm, ta)
    assert pkernel.pme_average_cuda.launches == before
    torch.testing.assert_close(out, pme_average_ref(tw, tm.float(), ta), rtol=0, atol=0)


@pytest.mark.parametrize("m", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pme_average_receiver_range_is_the_square_forms_rows(m, dtype):
    """The plain receiver-range form (every row sends, receivers r0 ...
    r0 + r - 1) equals the square form's rows bit for bit, for every r
    and r0, at the trainer's node counts; the wrapper takes it on the
    CPU."""
    w, masks, a = _pme_inputs(m, 300, getattr(jnp, dtype), 7 + m)
    a[:, 1] = 0  # receiver 1 hears nobody: its own row is the fill
    tw, tm, ta = to_t(w), torch.as_tensor(masks).to(to_t(w).dtype), torch.as_tensor(a)
    square = pme_average_ref(tw, tm, ta)
    for r in range(1, m + 1):
        for r0 in range(m - r + 1):
            got = pme_average_ref(tw, tm, ta, receivers=(r0, r))
            assert got.shape == (r, 300) and got.dtype == tw.dtype
            assert torch.equal(got, square[r0:r0 + r])
            assert torch.equal(pme_average(tw, torch.as_tensor(masks), ta, (r0, r)), got)
    with pytest.raises(ValueError, match="receivers"):
        pkernel.pme_average_cuda(tw, tm, ta, receivers=(m - 1, 2))


def test_fake_kernel_route_shapes_and_refusals():
    """Inside the dry run's kernel route each wrapper takes its kernel's
    route on fake tensors: outputs of the kernel's shapes and types, no
    launch counted; a real tensor there raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import fake_route

    counts = (pkernel.pme_average_cuda.launches, fkernel.flash_attention_cuda.launches,
              skernel.ssd_intra_chunk_cuda.launches, gkernel.gossip_gather.launches)
    with FakeTensorMode(), fake_route.kernel_route():
        w = torch.empty(4, 1000, dtype=torch.bfloat16)
        out = pme_average(w, torch.empty(4, 1000, dtype=torch.bool), torch.empty(4, 4),
                          receivers=(1, 2))
        assert out.shape == (2, 1000) and out.dtype == torch.bfloat16
        q = torch.empty(2, 256, 8, 64, dtype=torch.bfloat16)
        kv = torch.empty(2, 256, 2, 64, dtype=torch.bfloat16)
        o = flash_attention(q, kv, kv, window=128)
        assert o.shape == q.shape and o.dtype == torch.bfloat16
        y, st = ssd_intra_chunk(torch.empty(1, 2, 64, 4, 16, dtype=torch.bfloat16),
                                torch.empty(1, 2, 64, 4), torch.empty(1, 2, 64, 4),
                                torch.empty(1, 2, 64, 1, 32, dtype=torch.bfloat16),
                                torch.empty(1, 2, 64, 1, 32, dtype=torch.bfloat16), 4)
        assert y.shape == (1, 2, 64, 4, 16) and st.shape == (1, 2, 4, 16, 32)
        assert st.dtype == torch.float32
        nbrs = torch.zeros(3, 2, dtype=torch.int64)
        x = torch.empty(5, 7, 3)
        (g,) = gather_terms_kernel(nbrs, [(torch.ones(3, 2), x)])
        assert g.shape == (3, 7, 3)
    assert counts == (pkernel.pme_average_cuda.launches, fkernel.flash_attention_cuda.launches,
                      skernel.ssd_intra_chunk_cuda.launches, gkernel.gossip_gather.launches)
    with fake_route.kernel_route():
        with pytest.raises(RuntimeError, match="fake tensors only"):
            pkernel.pme_average_cuda(torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(2, 2))
        with pytest.raises(RuntimeError, match="fake tensors only"):
            flash_attention(torch.zeros(1, 8, 2, 64), torch.zeros(1, 8, 2, 64),
                            torch.zeros(1, 8, 2, 64))


def test_kernel_launchers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        pkernel.pme_average_cuda(torch.zeros(2, 4), torch.zeros(2, 4), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        gkernel.gossip_gather(torch.zeros(2, 2, dtype=torch.int32),
                              torch.zeros(1, 2, 2), [torch.zeros(2, 4)], (0,))


def _star_padded(m=9):
    pm = make_mixer(jbuild("star", m), "sparse").pm
    return pm.nbrs, pm.w, pm.pad


def _assert_port_matches(nbrs, terms, pad=None, atol=ATOL):
    """JAX's kernel (interpret) vs the port's plain version, its CPU
    wrapper, and the port's slots / segsum against JAX's slots chain."""
    want = gather_terms_pallas(nbrs, terms, pad=pad)
    chain = jgather(nbrs, terms, pad=pad, impl="slots")
    tn = to_t(nbrs)
    tterms = [(to_t(w), to_t(x)) for w, x in terms]
    # shared weight objects stay shared across the conversion
    ids = {}
    tterms = [(ids.setdefault(id(w), tw), tx) for (w, _), (tw, tx) in zip(terms, tterms)]
    tpad = None if pad is None else to_t(pad)
    outs = {
        "ref": gather_terms_ref(tn, tterms, pad=tpad),
        "ops": gather_terms_kernel(tn, tterms, pad=tpad),
        "kernel-impl": tmix.gather_terms(tn, tterms, pad=tpad, impl="kernel"),
    }
    for name, got in outs.items():
        for g, r in zip(got, want):
            assert tuple(g.shape) == r.shape
            np.testing.assert_allclose(to_np(g), np.asarray(r), atol=atol, err_msg=name)
    # slots/segsum need finite padding weights, as in JAX
    if pad is not None:
        clean = [(torch.where(tpad, torch.zeros_like(w), w), x) for w, x in tterms]
    else:
        clean = tterms
    for impl in ("slots", "segsum"):
        got = tmix.gather_terms(tn, clean, pad=tpad, impl=impl)
        for g, r in zip(got, chain if pad is None else want):
            np.testing.assert_allclose(to_np(g), np.asarray(r), atol=atol, err_msg=impl)


def test_gossip_star_hub_poisoned_padding():
    nbrs, w, pad = _star_padded()
    x = jnp.asarray(np.random.default_rng(0).standard_normal((9, 33)), jnp.float32)
    poisoned = jnp.where(pad, jnp.nan, w)
    _assert_port_matches(nbrs, [(poisoned, x)], pad=pad)
    out = gather_terms_ref(to_t(nbrs), [(to_t(poisoned), to_t(x))], pad=to_t(pad))[0]
    assert torch.isfinite(out).all()


def test_gossip_isolated_node():
    nbrs = jnp.asarray([[1, 0], [0, 1], [0, 2], [3, 3]], jnp.int32)
    w = jnp.asarray([[0.5, 0.5], [0.5, 0.5], [1.0, 0.0], [1.0, 0.0]], jnp.float32)
    pad = jnp.asarray([[False, False], [False, False], [False, False], [False, True]])
    x = jnp.asarray(np.random.default_rng(1).standard_normal((4, 11)), jnp.float32)
    _assert_port_matches(nbrs, [(jnp.where(pad, jnp.nan, w), x)], pad=pad)
    for impl in tmix.IMPLS:
        out = tmix.gather_terms(to_t(nbrs), [(to_t(w), to_t(x))], pad=to_t(pad), impl=impl)[0]
        np.testing.assert_array_equal(to_np(out[3]), np.asarray(x[3]), err_msg=impl)


def test_gossip_multi_term_shared_weights():
    m, k = 12, 5
    rng = np.random.default_rng(3)
    nbrs = jnp.asarray(rng.integers(0, m, (m, k)), jnp.int32)
    w0 = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    w1 = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    xs = [jnp.asarray(rng.standard_normal((m, 20)), jnp.float32) for _ in range(3)]
    _assert_port_matches(nbrs, [(w0, xs[0]), (w1, xs[1]), (w0, xs[2])])


def test_gossip_mixed_leaf_ranks_and_receiver_grid():
    m, k = 37, 4
    rng = np.random.default_rng(9)
    nbrs = jnp.asarray(rng.integers(0, m, (m, k)), jnp.int32)
    w = jnp.asarray(rng.standard_normal((m, k)), jnp.float32)
    xs = [jnp.asarray(rng.standard_normal(s), jnp.float32)
          for s in [(m,), (m, 130), (m, 2, 3)]]
    _assert_port_matches(nbrs, [(w, x) for x in xs])


@pytest.mark.parametrize("seed", [0, 4])
def test_gossip_integer_data_slots_bitwise(seed):
    """Small-integer data and dyadic weights: every partial sum is exact,
    so the port's slots chain equals JAX's bit for bit."""
    m, k = 9, 4
    rng = np.random.default_rng(seed)
    nbrs = jnp.asarray(rng.integers(0, m, (m, k)), jnp.int32)
    w = jnp.full((m, k), 0.125, jnp.float32)
    x = jnp.asarray(rng.integers(-64, 64, (m, 9)).astype(np.float32))
    want = np.asarray(jgather(nbrs, [(w, x)], impl="slots")[0])
    for impl in tmix.IMPLS:
        got = tmix.gather_terms(to_t(nbrs), [(to_t(w), to_t(x))], impl=impl)[0]
        np.testing.assert_array_equal(to_np(got), want, err_msg=impl)


def test_impl_resolution(monkeypatch):
    monkeypatch.delenv(tmix.ENV_VAR, raising=False)
    assert tmix.default_impl(torch.device("cpu")) == "slots"
    assert tmix.default_impl(torch.device("cuda")) == "kernel"
    for impl in tmix.IMPLS:
        monkeypatch.setenv(tmix.ENV_VAR, impl)
        assert tmix.default_impl(torch.device("cuda")) == impl
    monkeypatch.setenv(tmix.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match=tmix.ENV_VAR):
        tmix.default_impl()
    with pytest.raises(ValueError, match="bogus"):
        tmix.gather_terms(torch.zeros(2, 2, dtype=torch.int32),
                          [(torch.zeros(2, 2), torch.zeros(2, 3))], impl="bogus")


# ---------------------------------------------------------------------------
# flash attention and SSD intra-chunk: plain versions against JAX's kernels
# (tolerances of tests/test_kernels.py: flash 2e-5 f32 / 2e-2 bf16, SSD 1e-4)
# ---------------------------------------------------------------------------
FLASH_SWEEP = [
    (2, 64, 4, 2, 16, None, 32),
    (1, 128, 4, 4, 32, None, 64),
    (2, 64, 4, 2, 16, 24, 16),
    (1, 64, 8, 1, 64, None, 32),   # extreme GQA
    (1, 32, 2, 2, 8, 5, 16),       # window < block
]
SSD_SHAPES = [(2, 3, 16, 4, 8, 2, 8), (1, 2, 32, 2, 16, 1, 4), (1, 1, 8, 8, 4, 4, 16)]


def _flash_inputs(b, s, h, kv, d, dtype):
    rng = np.random.default_rng(s + h)
    return [jnp.asarray(rng.standard_normal(shape), dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("b,s,h,kv,d,win,blocks", FLASH_SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(b, s, h, kv, d, win, blocks, dtype):
    q, k, v = _flash_inputs(b, s, h, kv, d, getattr(jnp, dtype))
    kernel = jflash(q, k, v, window=win, block_q=blocks, block_k=blocks)
    ref = jattention_ref(q, k, v, window=win)
    tq, tk, tv = to_t(q), to_t(k), to_t(v)
    before = fkernel.flash_attention_cuda.launches
    got = flash_attention(tq, tk, tv, window=win, block_q=blocks, block_k=blocks)
    assert fkernel.flash_attention_cuda.launches == before
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    torch.testing.assert_close(got, attention_ref(tq, tk, tv, win), rtol=0, atol=0)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in (kernel, ref):
        np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32), atol=tol)


def test_flash_attention_wrapper_checks():
    q = torch.zeros(1, 48, 2, 8)
    with pytest.raises(ValueError, match="divisible by blocks"):
        flash_attention(q, q, q, block_q=32, block_k=32)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention(q.clone().requires_grad_(True), q, q)
    with torch.no_grad():  # no grad mode: the same call is allowed
        flash_attention(q.clone().requires_grad_(True), q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fkernel.flash_attention_cuda(q, q, q)


def _ssd_inputs(b, nc, l, h, p, g, n):
    rng = np.random.default_rng(b * 100 + l)
    xc = jnp.asarray(rng.standard_normal((b, nc, l, h, p)), jnp.float32)
    dtc = jnp.asarray(rng.random((b, nc, l, h)) * 0.2 + 0.01, jnp.float32)
    a = jnp.asarray(-np.exp(rng.standard_normal(h) * 0.2), jnp.float32)
    cum = jnp.cumsum(dtc * a[None, None, None], axis=2)
    bc = jnp.asarray(rng.standard_normal((b, nc, l, g, n)), jnp.float32)
    cc = jnp.asarray(rng.standard_normal((b, nc, l, g, n)), jnp.float32)
    return xc, dtc, cum, bc, cc


@pytest.mark.parametrize("b,nc,l,h,p,g,n", SSD_SHAPES)
def test_ssd_intra_chunk_plain_matches_jax(b, nc, l, h, p, g, n):
    args = _ssd_inputs(b, nc, l, h, p, g, n)
    y_k, st_k = jssd_intra_chunk(*args, h // g)
    targs = [to_t(x) for x in args]
    before = skernel.ssd_intra_chunk_cuda.launches
    y, st = ssd_intra_chunk(*targs, h // g)
    assert skernel.ssd_intra_chunk_cuda.launches == before
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    np.testing.assert_allclose(to_np(y), np.asarray(y_k), atol=1e-4)
    np.testing.assert_allclose(to_np(st), np.asarray(st_k), atol=1e-4)


def test_ssd_intra_chunk_wrapper_checks():
    targs = [to_t(x) for x in _ssd_inputs(1, 1, 8, 8, 4, 4, 16)]
    with pytest.raises(RuntimeError, match="forward only"):
        ssd_intra_chunk(targs[0].requires_grad_(True), *targs[1:], 2)
    with pytest.raises(ValueError, match="CUDA"):
        skernel.ssd_intra_chunk_cuda(*targs, 2)
    # the serving shape fits one block's shared memory, with the padded rows
    assert skernel.smem_bytes(128, 64, 64) == 4 * (2 * 64 * 132 + 128 * 64 + 128 * 128 + 3 * 128)
    # a 128-wide state only fits unpadded
    assert skernel.smem_bytes(128, 64, 128) <= skernel.MAX_SMEM


# ---------------------------------------------------------------------------
# the kernels' two variants: dispatch by type and shape alone, and the
# tensor-core variants' rounding rehearsed in plain PyTorch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_cores"), (torch.bfloat16, 128, "tensor_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.bfloat16, 8, "cuda_cores"), (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores"), (torch.bfloat16, 256, "cuda_cores"),
    (torch.float32, 8, "cuda_cores"),
    (torch.bfloat16, 48, ValueError), (torch.float32, 512, ValueError),
    (torch.float16, 64, TypeError),
])
def test_flash_variant_dispatch(dtype, d, want):
    if isinstance(want, str):
        assert fkernel.flash_variant(dtype, d) == want
    else:
        with pytest.raises(want):
            fkernel.flash_variant(dtype, d)


@pytest.mark.parametrize("dtype,l,p,n,want", [
    (torch.bfloat16, 128, 64, 64, "tensor_cores"),    # zamba2-1.2b
    (torch.bfloat16, 128, 64, 128, "tensor_cores"),   # mamba2-1.3b
    (torch.bfloat16, 64, 32, 16, "tensor_cores"),     # a short chunk
    (torch.bfloat16, 128, 128, 256, "tensor_cores"),
    (torch.bfloat16, 37, 12, 20, "cuda_cores"), (torch.bfloat16, 128, 8, 64, "cuda_cores"),
    (torch.bfloat16, 16, 64, 4, "cuda_cores"), (torch.bfloat16, 128, 144, 64, "cuda_cores"),
    (torch.float32, 128, 64, 64, "cuda_cores"), (torch.float32, 128, 64, 128, "cuda_cores"),
    (torch.bfloat16, 256, 64, 64, ValueError), (torch.float32, 128, 6, 64, ValueError),
    (torch.bfloat16, 128, 64, 6, ValueError), (torch.float32, 128, 128, 128, ValueError),
    (torch.float16, 128, 64, 64, TypeError),
])
def test_ssd_variant_dispatch(dtype, l, p, n, want):
    if isinstance(want, str):
        assert skernel.ssd_variant(dtype, l, p, n) == want
    else:
        with pytest.raises(want):
            skernel.ssd_variant(dtype, l, p, n)


def test_tensor_core_shared_memory_fits_the_blocks_per_sm():
    """At path C's shapes the tensor-core blocks fit the blocks an SM they
    are built for (228 KB an SM, 1 KB of it reserved per block): flash one
    persistent block of three warpgroups (its registers fill the SM's
    file), two q tiles, four stages of K and V and the barriers; SSD
    several."""
    sm = 233472
    assert fkernel.tc_smem_bytes(64) == 1024 + 2 * 16384 + 4 * 32768 + 104
    assert fkernel.tc_smem_bytes(128) == 1024 + 2 * 32768 + 4 * 32768 + 104
    for d in fkernel.TC_HEAD_DIMS:
        assert fkernel.tc_smem_bytes(d) + 1024 <= sm < 2 * (fkernel.tc_smem_bytes(d) + 1024)
    assert skernel.tc_smem_bytes(128, 64, 64) == 56832
    assert 4 * (skernel.tc_smem_bytes(128, 64, 64) + 1024) <= sm
    assert 2 * (skernel.tc_smem_bytes(128, 64, 128) + 1024) <= sm


def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x, parts, rnd=_bf):
    """x as `parts` bf16 terms (or of `rnd`'s type), leading first (the
    kernels' hi / mid / lo)."""
    out = []
    for _ in range(parts):
        out.append(rnd(x))
        x = x - out[-1]
    return out


def _bf16_ulps_floored(got, want):
    """As chip_smoke.py: |got - want| in bf16 ulps of max(|want|, max|want| / 256)."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


def _flash_tc_model(q, k, v, window, p_parts, sub=None, rnd=_bf):
    """The tensor-core flash kernel's arithmetic in plain PyTorch: keys in
    tiles of `sub` (the kernel's `tc_key_tile(D)` by default), a running
    max in unscaled scores, p = 2^(s c - m c), P split into `p_parts` bf16
    terms (or of `rnd`'s type), each tile's P V from zero (products exact,
    sums f32) meeting the rescaled O once a tile, output rounded once to
    bf16.  q, k, v bf16 [B, S, H, D], H == KV."""
    b, s, h, d = q.shape
    sub = sub or fkernel.tc_key_tile(d)
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, S, D]
    c = d ** -0.5 * 1.4426950408889634
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    i = torch.arange(s)[:, None]
    for k0 in range(0, s, sub):
        sc = qf @ kf[:, :, k0:k0 + sub].transpose(-1, -2)
        j = torch.arange(k0, min(s, k0 + sub))[None, :]
        ok = (j <= i) & ((i - j) < window if window else True)
        sc = torch.where(ok, sc, -torch.inf)
        mn = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mn) * c)
        p = torch.exp2(sc * c - mn * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = sum(pp @ vf[:, :, k0:k0 + sub] for pp in _split(p, p_parts, rnd))
        acc = torch.addcmul(pv, acc, alpha)
        m = mn
    return (acc / l.clamp(min=1e-30)).transpose(1, 2).to(torch.bfloat16)


# ids "None" and "40" are the D = 64 cases, as before D = 128 was added
@pytest.mark.parametrize("window,d", [(None, 64), (40, 64), (None, 128), (40, 128)],
                         ids=["None", "40", "d128-None", "d128-40"])
def test_flash_tensor_core_rounding_model(window, d):
    """P split into bf16 hi + lo, in the kernel's key tiles (128 keys at
    D = 64, 64 at D = 128), keeps the kernel's output within one bf16 ulp
    (floored) of the f32 plain version at S = 512; P rounded to one bf16
    would not (the reason for the second product), nor to one fp16 (three
    bits more, and V would have to be fp16 too)."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 4, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = attention_ref(q.float(), k.float(), v.float(), window)
    split = _flash_tc_model(q, k, v, window, 2)
    assert split.dtype == torch.bfloat16 and torch.isfinite(split).all()
    assert _bf16_ulps_floored(split, want) <= 1.0
    assert _bf16_ulps_floored(_flash_tc_model(q, k, v, window, 1), want) > 2.0
    fp16 = _flash_tc_model(q, k, v, window, 1, rnd=lambda x: x.half().float())
    assert _bf16_ulps_floored(fp16, want) > 2.0


def test_flash_tensor_core_variant_is_built_on_hoppers_instructions():
    """The tensor-core variant takes both products by wgmma, copies q, K and
    V by TMA into a ring that mbarriers guard, and splits its warpgroups
    into a producer and consumers with setmaxnreg; it issues no mma.sync,
    ldmatrix or cp.async of its own.  The header it takes those from is
    hashed into the library's name."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    tc = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    for call in ("wgmma_ss<", "wgmma_rs<", "tma_load_4d(", "tma_store_4d(", "mbar_wait(",
                 "mbar_arrive_expect_tx(", "setmaxnreg_dec<", "setmaxnreg_inc<",
                 "__grid_constant__ CUtensorMap"):
        assert call in tc, call
    for call in ("mma(", "ldmatrix", "cp_async16(", "mma.sync"):
        assert call not in tc, call
    header = (_build.CSRC / "hopper_sm90.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "mbarrier.arrive.expect_tx", "setmaxnreg", "cudaGetDriverEntryPoint"):
        assert ptx in header, ptx
    assert "hopper_sm90.cuh" in [f.name for f in _build._sources(_build.CSRC / "flash_attention.cu")]


def _ssd_tc_model(xc, dtc, cum, bc, cc, rep, w_parts, state_parts):
    """The tensor-core SSD kernel's arithmetic in plain PyTorch: C B^T from
    bf16 operands in f32, W = that * exp(cum_i - cum_j) * dt_j for j <= i,
    W split into `w_parts` bf16 terms for W x, x * dec into `state_parts`
    for the state; y rounded once to x's type."""
    l = xc.shape[2]
    x = xc.float()
    b_ = bc.float().repeat_interleave(rep, 3)
    c_ = cc.float().repeat_interleave(rep, 3)
    sc = torch.einsum("bclhn,bcmhn->bchlm", c_, b_)
    cum_h = cum.permute(0, 1, 3, 2)  # [B, Nc, H, L]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
    seg = torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :], 0.0)
    w = torch.where(causal, sc * torch.exp(seg) * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = sum(torch.einsum("bchlm,bcmhp->bclhp", wp, x) for wp in _split(w, w_parts))
    dec = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    xd = x * dec[..., None]
    st = sum(torch.einsum("bclhp,bclhn->bchpn", a, b_) for a in _split(xd, state_parts))
    return y.to(xc.dtype), st


@pytest.mark.parametrize("n", [64, 128])
def test_ssd_tensor_core_rounding_model(n):
    """W split into bf16 hi + lo and x * dec into hi + mid + lo keep the
    kernel's y within one bf16 ulp (floored) and its state within
    1e-5 x scale of the f32 plain version at L = 128, P = 64; W rounded to
    one bf16 would not."""
    b, nc, l, h, p, g = 1, 2, 128, 8, 64, 1
    rng = np.random.default_rng(n)
    rnd = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    xc = rnd(b, nc, l, h, p).to(torch.bfloat16)
    dtc = torch.from_numpy((rng.random((b, nc, l, h)) * 0.2 + 0.01).astype(np.float32))
    cum = torch.cumsum(dtc * -torch.exp(rnd(h) * 0.2), dim=2)
    bc, cc = rnd(b, nc, l, g, n).to(torch.bfloat16), rnd(b, nc, l, g, n).to(torch.bfloat16)
    y_r, st_r = ssd_intra_chunk_ref(xc.float(), dtc, cum, bc.float(), cc.float(), h // g)
    y, st = _ssd_tc_model(xc, dtc, cum, bc, cc, h // g, 2, 3)
    assert _bf16_ulps_floored(y, y_r) <= 1.0
    assert (st - st_r).abs().max().item() <= 1e-5 * max(1.0, st_r.abs().max().item())
    y1, _ = _ssd_tc_model(xc, dtc, cum, bc, cc, h // g, 1, 3)
    assert _bf16_ulps_floored(y1, y_r) > 2.0


def test_build_target_hashes_included_headers(tmp_path):
    """An edited header under csrc/ gives the kernel a new library name (so
    it is rebuilt); an edit elsewhere does not."""
    from repro_torch.kernels import _build

    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "h.cuh"\nint f();\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    first = _build._target("k", csrc=tmp_path)
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert [f.name for f in _build._sources(tmp_path / "k.cu")] == ["k.cu", "h.cuh", "g.cuh"]
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert _build._target("k", csrc=tmp_path) == first
    (tmp_path / "g.cuh").write_text("// v2\n")
    second = _build._target("k", csrc=tmp_path)
    assert second != first
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n// edited\n')
    assert _build._target("k", csrc=tmp_path) not in (first, second)
    # the port's own kernels: the two tensor-core sources hash mma_bf16.cuh
    for name in ("flash_attention", "ssd_intra_chunk"):
        assert "mma_bf16.cuh" in [f.name for f in _build._sources(_build.CSRC / f"{name}.cu")]


@pytest.mark.parametrize("module,lib,entry", [(pkernel, "pme_average", "pme_average_range"),
                                              (gkernel, "gossip_gather", "gossip_gather")])
def test_bind_loads_and_types_the_entry_point_once(monkeypatch, module, lib, entry):
    """A wrapper's `_bind` loads its library and sets the C function's
    argtypes at its first call only: later launches pay for neither."""
    import ctypes

    from repro_torch.kernels import _build

    loads, typed = [], []

    class Fn:
        def __setattr__(self, name, value):
            if name == "argtypes":
                typed.append(value)
            object.__setattr__(self, name, value)

    fn = Fn()
    library = type("Library", (), {entry: fn})()
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or library)
    module._bind.cache_clear()
    try:
        assert module._bind() is fn
        assert module._bind() is fn
    finally:
        module._bind.cache_clear()
    assert loads == [lib] and len(typed) == 1
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    assert typed[0][0] is ctypes.c_void_p and typed[0][-1] is ctypes.c_void_p
    assert fn.restype is ctypes.c_int
