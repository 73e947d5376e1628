"""`Mixer` of the port against the JAX package's: the four methods (mix,
mix_lazy, mix_half, mix_nids_quantized) in the three modes on f32 pytrees
of mixed leaf ranks, against JAX's "slots" contraction, to 1e-6; bf16
operands through the port's kernel route (its plain version on the CPU)
against JAX's Pallas kernel in interpret mode, to one bf16 ulp; and the
constructors' checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mixing as jmix
from repro.core.topology import build_topology as jbuild
from repro_torch.core import mixing as tmix
from repro_torch.core.topology import build_topology as tbuild
from repro_torch.tree import tree_leaves

from _torch_parity import to_np, to_t

MODES = ("matrix", "dense", "sparse")
TOPOS = [("erdos_renyi", 7, {"p": 0.5, "seed": 3}), ("star", 9, {}), ("ring", 6, {})]


def _tree(m, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((m, 5)).astype(dtype),
            "b": [rng.standard_normal((m,)).astype(dtype),
                  rng.standard_normal((m, 2, 3)).astype(dtype)]}


def _both(kind, m, kw, mode, impl_j="slots", impl_t=None):
    return (jmix.make_mixer(jbuild(kind, m, **kw), mode, impl=None if mode == "matrix" else impl_j),
            tmix.make_mixer(tbuild(kind, m, **kw), mode, impl=impl_t))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind,m,kw", TOPOS, ids=[t[0] for t in TOPOS])
def test_mixer_methods_match_jax(kind, m, kw, mode):
    mj, mt = _both(kind, m, kw, mode, impl_t="slots")
    x_np, u_np = _tree(m, 1), _tree(m, 2)
    xj, uj = jax.tree_util.tree_map(jnp.asarray, x_np), jax.tree_util.tree_map(jnp.asarray, u_np)
    xt = {"a": torch.as_tensor(x_np["a"]), "b": [torch.as_tensor(v) for v in x_np["b"]]}
    ut = {"a": torch.as_tensor(u_np["a"]), "b": [torch.as_tensor(v) for v in u_np["b"]]}
    for method, args_j, args_t in (
        ("mix", (xj,), (xt,)),
        ("mix_lazy", (xj,), (xt,)),
        ("mix_half", (xj,), (xt,)),
        ("mix_nids_quantized", (xj, uj), (xt, ut)),
    ):
        want = jax.tree_util.tree_leaves(getattr(mj, method)(*args_j))
        got = tree_leaves(getattr(mt, method)(*args_t))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-6, err_msg=method)


@pytest.mark.parametrize("kind,m,kw", TOPOS, ids=[t[0] for t in TOPOS])
def test_dense_and_sparse_bit_identical(kind, m, kw):
    """The full-connectivity padded form adds exact 0.0 terms only, in the
    same ascending order: "dense" equals "sparse" bit for bit under the
    slots chain and the kernel route."""
    topo = tbuild(kind, m, **kw)
    x = torch.as_tensor(_tree(m, 4)["a"])
    for impl in ("slots", "kernel"):
        d = tmix.make_mixer(topo, "dense", impl=impl)
        s = tmix.make_mixer(topo, "sparse", impl=impl)
        torch.testing.assert_close(d.mix(x), s.mix(x), rtol=0, atol=0)
        torch.testing.assert_close(d.mix_lazy(x), s.mix_lazy(x), rtol=0, atol=0)


def _bf16_ulps_floored(got, want):
    """max |got - want| in bf16 ulps of max(|want|, max|want| / 256): f32
    sums taken in another order differ by more than an ulp of an output
    that cancels to nearly 0."""
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("kind,m,kw", TOPOS, ids=[t[0] for t in TOPOS])
def test_bf16_kernel_route_matches_jax_pallas(kind, m, kw, mode):
    """bf16 operands: JAX's Pallas kernel (interpret mode) contracts in f32
    and rounds once to bf16, as the port's kernel route does (on the CPU
    its plain version, an f32 matmul).  The f32 sums may differ in order,
    so the rounded outputs agree within one bf16 ulp (floored at 1/256 of
    the output's scale); the port's route is also within one such ulp of
    the f32 slots chain rounded once, which the CUDA kernel equals bit for
    bit (tests/test_torch_cuda_kernels.py)."""
    mj, mt = _both(kind, m, kw, mode, impl_j="pallas", impl_t="kernel")
    x = jnp.asarray(np.random.default_rng(m).standard_normal((m, 300)), jnp.bfloat16)
    u = jnp.asarray(np.random.default_rng(m + 1).standard_normal((m, 300)), jnp.bfloat16)
    xt, ut = to_t(x), to_t(u)
    got = mt.mix(xt)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps_floored(got, to_t(mj.mix(x))) <= 1.0
    slots = tmix.gather_terms(mt.pm.nbrs, [(mt.pm.w, xt.float())], pad=mt.pm.pad, impl="slots")[0]
    assert _bf16_ulps_floored(got, slots.to(torch.bfloat16)) <= 1.0
    for method, args_j, args_t in (("mix_lazy", (x,), (xt,)), ("mix_half", (x,), (xt,)),
                                    ("mix_nids_quantized", (x, u), (xt, ut))):
        want = to_t(getattr(mj, method)(*args_j)).float()
        out = getattr(mt, method)(*args_t)
        assert out.dtype == torch.bfloat16
        # one ulp of the mixed value, carried through one bf16 op after it
        scale = want.abs().max().item()
        assert (out.float() - want).abs().max().item() <= 2 ** -6 * max(scale, 1.0), method


def test_padded_form_helpers():
    topo = tbuild("erdos_renyi", 8, p=0.4, seed=2)
    mx = tmix.make_mixer(topo, "sparse")
    assert mx.m == mx.pm.m == 8
    np.testing.assert_allclose(to_np(mx.pm.self_weight), np.diag(topo.mixing), atol=1e-7)
    pm2 = mx.pm.with_weights(mx.pm.w * 2)
    assert pm2.nbrs is mx.pm.nbrs and torch.equal(pm2.w, mx.pm.w * 2)
    dense = tmix._dense_padded(torch.as_tensor(topo.mixing, dtype=torch.float32))
    assert dense.nbrs.shape == (8, 8) and dense.pad is None
    torch.testing.assert_close(dense.self_weight, mx.pm.self_weight, rtol=0, atol=0)


def test_make_mixer_and_as_mixer_checks():
    topo = tbuild("ring", 5)
    with pytest.raises(ValueError, match="unknown mixing mode"):
        tmix.make_mixer(topo, "bogus")
    with pytest.raises(ValueError, match="impl"):
        tmix.make_mixer(topo, "sparse", impl="pallas")
    b = torch.as_tensor(topo.mixing, dtype=torch.float32)
    raw = tmix.as_mixer(b)
    assert raw.mode == "matrix" and raw.b is b
    mx = tmix.make_mixer(topo, "dense")
    assert tmix.as_mixer(mx) is mx
    x = torch.randn(5, 4)
    torch.testing.assert_close(raw.mix(x), b.T @ x, rtol=1e-6, atol=1e-6)
