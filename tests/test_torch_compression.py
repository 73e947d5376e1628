"""The five compressors of the port against the JAX package, with JAX's
uniforms injected: in f32 to 1e-6 (a different summation order of the QSGD
norm and the one-bit mean is all that may differ), and their wire bits
exactly.  QSGD is also held in bf16, where it matches bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compression as jc
from repro_torch.core import compression as tc

from _torch_parity import to_np, to_t

CASES = [
    ("identity", {}),
    ("rand_k", {"frac": 0.3}),
    ("rand_k", {"frac": 0.3, "rescale": False}),
    ("rand_k", {"frac": 0.05, "value_bits": 32}),
    ("top_k", {"frac": 0.2}),
    ("qsgd", {"levels": 16}),
    ("qsgd", {"levels": 4}),
    ("one_bit", {}),
]
IDS = [f"{name}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for name, kw in CASES]


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 30), (4, 257), (1, 1000)])
@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_apply_matches_jax(name, kw, shape):
    x = _x(shape, shape[1])
    key = jax.random.PRNGKey(shape[0] + shape[1])
    want = np.asarray(getattr(jc, name)(**kw).apply(key, jnp.asarray(x)))
    # rand_k draws uniform(key, x.shape); qsgd bernoulli(key, p, x.shape),
    # i.e. uniform(key, x.shape, f32) < p
    u = to_t(jax.random.uniform(key, shape))
    got = getattr(tc, name)(**kw).apply(torch.as_tensor(x), u=u)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_bits_match_jax(name, kw):
    jcomp, tcomp = getattr(jc, name)(**kw), getattr(tc, name)(**kw)
    assert tcomp.name == jcomp.name
    for n in (1, 7, 100, 4097, 276_824_064):
        assert tcomp.bits(n) == jcomp.bits(n)


@pytest.mark.parametrize("frac", [0.2, 0.3])
def test_rand_k_keeps_exactly_s_per_row_from_own_draws(frac):
    x = torch.as_tensor(_x((4, 1001), 5)) + 3.0  # no zero entries
    g = torch.Generator().manual_seed(0)
    out = tc.rand_k(frac, rescale=False).apply(x, generator=g)
    s = max(1, round(frac * 1001))
    assert ((out != 0).sum(dim=1) == s).all()
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept], rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 9])
def test_qsgd_bf16_against_jax(seed):
    """bf16 in both frameworks, JAX's bf16 uniforms injected.  The hazard
    is XLA fusing the |x| / ||x|| · levels chain and rounding it once where
    torch rounds every op, which would move a coordinate near a level
    boundary by one level.  With jax 0.9.0 on the CPU the two agree bit for
    bit on these inputs, and the test holds them to that."""
    x = jnp.asarray(_x((4, 2048), seed), jnp.bfloat16)
    key = jax.random.PRNGKey(11 + seed)
    want = np.asarray(jc.qsgd(16).apply(key, x)).astype(np.float32)
    u = to_t(jax.random.uniform(key, x.shape, jnp.bfloat16))
    got = tc.qsgd(16).apply(to_t(x), u=u)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), want)
