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


def test_split_proj_not_yet_ported():
    with pytest.raises(NotImplementedError, match="ssm_split_proj"):
        ssm.mamba_init(torch.Generator(), MAMBA.replace(ssm_split_proj=True), torch.float32)
