"""The port's Mamba2 block against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages.  Tolerances: the chunked
SSD (kernel flag on and off) against JAX's token-by-token recurrence atol
2e-4, as tests/test_kernels.py holds JAX's own; a whole Mamba2 block and
its decode steps against JAX's atol 3e-4, as tests/test_decode_consistency.py
holds decode against the full forward (the port's inter-chunk recurrence
is a loop where JAX runs an associative scan, so sums run in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ssd_scan.ref import ssd_sequential_ref as jseq
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro_torch import convert
from repro_torch.kernels.ssd_scan.ref import ssd_sequential_ref
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig

from _torch_parity import to_np


def _ssd_case(bsz, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = (rng.random((bsz, s, h)) * 0.2 + 0.01).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.2)).astype(np.float32)
    b_ = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    c_ = rng.standard_normal((bsz, s, g, n)).astype(np.float32)
    return x, dt, a, b_, c_


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bsz,s,h,p,g,n,l", [
    (2, 32, 4, 8, 2, 8, 8),   # JAX's own case: 4 whole chunks
    (1, 27, 4, 8, 1, 16, 8),  # a padded last chunk
    (2, 5, 2, 4, 1, 4, 8),    # shorter than one chunk
])
def test_ssd_chunked_matches_jax_sequential(use_kernel, bsz, s, h, p, g, n, l):
    x, dt, a, b_, c_ = _ssd_case(bsz, s, h, p, g, n, seed=7 + s)
    want = np.asarray(jseq(*(jnp.asarray(v) for v in (x, dt, a, b_, c_)), h // g))
    cfg = ModelConfig("t", "ssm", n_layers=1, d_model=32, vocab=8, ssm_state=n,
                      ssm_head_dim=p, ssm_chunk=l, ssm_groups=g, use_ssd_kernel=use_kernel)
    y, final = ssm._ssd_chunked(cfg, *(torch.as_tensor(v) for v in (x, dt, a, b_, c_)))
    assert tuple(y.shape) == x.shape and final.dtype == torch.float32
    np.testing.assert_allclose(to_np(y), want, atol=2e-4)
    seq = ssd_sequential_ref(*(torch.as_tensor(v) for v in (x, dt, a, b_, c_)), h // g)
    np.testing.assert_allclose(to_np(seq), want, atol=1e-5)


MAMBA = ModelConfig("m", "ssm", n_layers=1, d_model=64, vocab=64, ssm_state=16,
                    ssm_head_dim=16, ssm_chunk=8, ssm_groups=2)


def _mamba_params(seed):
    """JAX's init with the constant leaves (A_log, D, dt_bias) drawn too."""
    params = jax.device_get(jssm.mamba_init(jax.random.PRNGKey(seed), JConfig(
        **{f: getattr(MAMBA, f) for f in MAMBA.__dataclass_fields__}), jnp.float32))
    rng = np.random.default_rng(seed)
    h = MAMBA.ssm_heads
    params = dict(params)
    params["A_log"] = (rng.standard_normal(h) * 0.3).astype(np.float32)
    params["D"] = rng.standard_normal(h).astype(np.float32)
    params["dt_bias"] = (rng.standard_normal(h) - 1.0).astype(np.float32)
    params["conv_b"] = (rng.standard_normal(MAMBA.conv_dim) * 0.1).astype(np.float32)
    return params


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_apply_and_decode_match_jax(use_kernel):
    cfg = MAMBA.replace(use_ssd_kernel=use_kernel)
    jcfg = JConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    pj = _mamba_params(3)
    pt = convert.to_torch(pj)
    x = np.random.default_rng(4).standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    out_j, cache_j = jssm.mamba_apply(pj, jcfg, jnp.asarray(x[:, :17]), return_cache=True)
    with torch.no_grad():
        out_t, cache_t = ssm.mamba_apply(pt, cfg, torch.as_tensor(x[:, :17]), return_cache=True)
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), atol=3e-4)
    for a, b in zip(cache_t, cache_j):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=3e-4)
    for t in range(17, 21):
        out_j, cache_j = jssm.mamba_decode(pj, jcfg, jnp.asarray(x[:, t: t + 1]), cache_j)
        out_t, cache_t = ssm.mamba_decode(pt, cfg, torch.as_tensor(x[:, t: t + 1]), cache_t)
        np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), atol=3e-4, err_msg=str(t))
        for a, b in zip(cache_t, cache_j):
            np.testing.assert_allclose(to_np(a), np.asarray(b), atol=3e-4)


def test_mamba_keeps_jax_dtypes_in_bf16():
    """A_log / D / dt_bias stay f32 in a bf16 block, the state is f32 and
    the block's output is bf16, as in JAX."""
    cfg = MAMBA.replace(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = ssm.mamba_init(gen, cfg, torch.bfloat16)
    assert {k: v.dtype for k, v in p.items() if v.dtype == torch.float32}.keys() == \
           {"A_log", "D", "dt_bias"}
    x = torch.randn(1, 12, cfg.d_model).to(torch.bfloat16)
    with torch.no_grad():
        out, cache = ssm.mamba_apply(p, cfg, x, return_cache=True)
    assert out.dtype == torch.bfloat16 and cache.state.dtype == torch.float32
    assert cache.conv.dtype == torch.bfloat16
    jp = jax.tree_util.tree_map(jnp.asarray, {k: to_np(v) for k, v in p.items()})
    jp = {k: v.astype(jnp.bfloat16) if p[k].dtype == torch.bfloat16 else v for k, v in jp.items()}
    jout, jcache = jssm.mamba_apply(jp, JConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__}),
                                    jnp.asarray(to_np(x), jnp.bfloat16), return_cache=True)
    assert str(jout.dtype) == "bfloat16" and str(jcache.state.dtype) == "float32"
    np.testing.assert_allclose(to_np(out), np.asarray(jout, np.float32), atol=5e-2)


def _split_cfg(groups, split=True):
    """tests/test_ssm_split.py's block."""
    return ModelConfig("t", "ssm", n_layers=1, d_model=32, vocab=8, ssm_state=8, ssm_head_dim=8,
                       ssm_chunk=4, ssm_groups=groups, ssm_split_proj=split)


def _jcfg(cfg):
    return JConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("groups", [1, 2])
def test_split_proj_matches_jax(groups):
    """ssm_split_proj: the per-stream projections and convolutions against
    JAX's on the same weights (conv biases drawn too), full sequence with
    its cache and three decode steps, atol 1e-5."""
    cfg = _split_cfg(groups)
    pj = dict(jax.device_get(jssm.mamba_init(jax.random.PRNGKey(0), _jcfg(cfg), jnp.float32)))
    rng = np.random.default_rng(groups)
    for k in ("conv_x_b", "conv_B_b", "conv_C_b"):
        pj[k] = (rng.standard_normal(pj[k].shape) * 0.1).astype(np.float32)
    tl = ssm.mamba_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    assert sorted(tl) == sorted(pj) and all(tuple(tl[k].shape) == pj[k].shape for k in pj)
    pt = convert.to_torch(pj)
    x = rng.standard_normal((2, 15, 32)).astype(np.float32)
    yj, cj = jssm.mamba_apply(pj, _jcfg(cfg), jnp.asarray(x[:, :12]), return_cache=True)
    with torch.no_grad():
        yt, ct = ssm.mamba_apply(pt, cfg, torch.as_tensor(x[:, :12]), return_cache=True)
    np.testing.assert_allclose(to_np(yt), np.asarray(yj), atol=1e-5)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5)
    for t in range(12, 15):
        yj, cj = jssm.mamba_decode(pj, _jcfg(cfg), jnp.asarray(x[:, t: t + 1]), cj)
        with torch.no_grad():
            yt, ct = ssm.mamba_decode(pt, cfg, torch.as_tensor(x[:, t: t + 1]), ct)
        np.testing.assert_allclose(to_np(yt), np.asarray(yj), atol=1e-5, err_msg=str(t))
        for a, b in zip(ct, cj):
            np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_split_proj_equals_fused_from_its_slices(groups):
    """tests/test_ssm_split.py's equivalence in the port: the split block,
    initialised from the fused block's slices, gives the fused outputs,
    full sequence and decode (atol 2e-6)."""
    from test_ssm_split import _split_from_fused

    cfg = _split_cfg(groups, split=False)
    pf = ssm.mamba_init(torch.Generator().manual_seed(1), cfg, torch.float32)
    ps = _split_from_fused(pf, cfg)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 12, 32)).astype(np.float32))
    with torch.no_grad():
        yf, cf = ssm.mamba_apply(pf, cfg, x, return_cache=True)
        ys, cs = ssm.mamba_apply(ps, cfg.replace(ssm_split_proj=True), x, return_cache=True)
        np.testing.assert_allclose(to_np(ys), to_np(yf), atol=2e-6)
        np.testing.assert_allclose(to_np(cs.conv), to_np(cf.conv), atol=2e-6)
        x1 = torch.as_tensor(np.random.default_rng(1).standard_normal((2, 1, 32)).astype(np.float32))
        yd_f, _ = ssm.mamba_decode(pf, cfg, x1, cf)
        yd_s, _ = ssm.mamba_decode(ps, cfg.replace(ssm_split_proj=True), x1, cs)
    np.testing.assert_allclose(to_np(yd_s), to_np(yd_f), atol=2e-6)


def test_split_proj_model_end_to_end_matches_jax():
    """tests/test_ssm_split.py's two-layer model: loss and gradients
    against JAX's (rtol 1e-5, atol 1e-4), all finite."""
    from repro.models import init_params as jinit, train_loss as jloss
    from repro_torch.models import train_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = ModelConfig("t", "ssm", n_layers=2, d_model=64, vocab=64, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=8, ssm_split_proj=True)
    pj = jinit(jax.random.PRNGKey(0), _jcfg(cfg))
    tok = np.random.default_rng(0).integers(0, 64, (2, 16)).astype(np.int32)
    lj, gj = jax.value_and_grad(lambda p: jloss(p, _jcfg(cfg), {"tokens": jnp.asarray(tok)}))(pj)
    leaves, td = tree_flatten(convert.to_torch(jax.device_get(pj)))
    leaves = [x.requires_grad_(True) for x in leaves]
    lt = train_loss(tree_unflatten(td, leaves), cfg, {"tokens": torch.as_tensor(tok)})
    grads = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(gj)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4)
