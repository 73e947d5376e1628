"""The port's plain kernel versions against the JAX kernels (Pallas in
interpret mode on the CPU), and the CPU dispatch of the port's wrappers.

Tolerances are those of the JAX kernel tests: f32 atol 1e-5, bf16 5e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_topology as jbuild
from repro.core.mixing import gather_terms as jgather, make_mixer
from repro.kernels.gossip.ops import gather_terms_pallas
from repro.kernels.pme_average.ops import pme_average as jpme_average
from repro_torch.core import mixing as tmix
from repro_torch.kernels.gossip import kernel as gkernel
from repro_torch.kernels.gossip.ops import gather_terms_kernel
from repro_torch.kernels.gossip.ref import gather_terms_ref
from repro_torch.kernels.pme_average import kernel as pkernel
from repro_torch.kernels.pme_average.ops import pme_average
from repro_torch.kernels.pme_average.ref import pme_average_ref

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
