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
