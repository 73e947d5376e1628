"""The port's MLA (multi-head latent attention) against the JAX package's,
on the CPU: `mla_apply` unchunked and in query chunks, without (lite) and
with (236b) the query's low-rank path and with a sliding window, outputs
and caches at atol 1e-5; the absorbed-form `mla_decode` against JAX's; and
a whole model's prefill plus greedy decode across a ring wrap against
JAX's `prefill` and `decode_step` (logits atol 1e-5, identical tokens).
The absorbed decode rounds differently from the full form, so decode is
held against JAX's own decode, not against the port's full forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import model as jm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import model as tm

from _torch_parity import to_np

ATOL = 1e-5
ARCHS = {"lite": "deepseek-v2-lite-16b", "236b": "deepseek-v2-236b"}  # q_lora 0 / 48


def _cfgs(arch, **kw):
    return (jget_config(ARCHS[arch], "smoke").replace(**kw),
            get_config(ARCHS[arch], "smoke").replace(**kw))


def _close(got, want, msg=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mla_apply_matches_jax(arch, chunk, window):
    cj, ct = _cfgs(arch, prefill_chunk=chunk, window=window)
    params = jax.device_get(jattn.mla_init(jax.random.PRNGKey(1), cj, jnp.float32))
    assert ("w_dq" in params) == (arch == "236b")
    x = np.random.default_rng(2).standard_normal((2, 12, cj.d_model)).astype(np.float32)
    pos = np.arange(12)
    yj, cache_j = jattn.mla_apply(jax.tree_util.tree_map(jnp.asarray, params), cj,
                                  jnp.asarray(x), jnp.asarray(pos), return_cache=True,
                                  cache_capacity=16)
    with torch.no_grad():
        yt, cache_t = attn.mla_apply(convert.to_torch(params), ct, torch.as_tensor(x),
                                     torch.as_tensor(pos), return_cache=True, cache_capacity=16)
    _close(yt, yj)
    for a, b in zip(cache_t, cache_j):
        _close(a, b, "cache")
    if chunk:  # the chunked route gives the unchunked outputs
        with torch.no_grad():
            y0, _ = attn.mla_apply(convert.to_torch(params), ct.replace(prefill_chunk=0),
                                   torch.as_tensor(x), torch.as_tensor(pos))
        np.testing.assert_allclose(to_np(yt), to_np(y0), atol=ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mla_decode_matches_jax(arch):
    """The absorbed decode (W_uk read as [kv_lora, h, nope], the scale
    (nope + rope_head_dim)^-0.5) writes slot pos % C, as JAX's."""
    cj, ct = _cfgs(arch)
    params = jax.device_get(jattn.mla_init(jax.random.PRNGKey(3), cj, jnp.float32))
    pj, pt = jax.tree_util.tree_map(jnp.asarray, params), convert.to_torch(params)
    x = np.random.default_rng(4).standard_normal((2, 9, cj.d_model)).astype(np.float32)
    cap = 6
    _, cj_cache = jattn.mla_apply(pj, cj, jnp.asarray(x[:, :5]), jnp.arange(5),
                                  return_cache=True, cache_capacity=cap)
    with torch.no_grad():
        _, ct_cache = attn.mla_apply(pt, ct, torch.as_tensor(x[:, :5]), torch.arange(5),
                                     return_cache=True, cache_capacity=cap)
        for t in range(5, 9):  # positions 6.. wrap the ring of 6
            yj, cj_cache = jattn.mla_decode(pj, cj, jnp.asarray(x[:, t: t + 1]), jnp.int32(t),
                                            cj_cache)
            yt, ct_cache = attn.mla_decode(pt, ct, torch.as_tensor(x[:, t: t + 1]), t, ct_cache)
            _close(yt, yj, f"step {t}")
            for a, b in zip(ct_cache, cj_cache):
                _close(a, b, f"cache at step {t}")
    assert to_np(ct_cache.positions).tolist() == [6, 7, 8, 3, 4, 5]


@pytest.mark.parametrize("chunk", [0, 3])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_across_ring_wrap_match_jax(arch, chunk):
    """A whole MLA + MoE model: prefill 9 tokens into a ring of 12, then 8
    greedy decode steps (positions 9..16 wrap the ring), step for step
    against JAX's prefill and decode_step."""
    cj, ct = _cfgs(arch, prefill_chunk=chunk)
    pj = jm.init_params(jax.random.PRNGKey(5), cj)
    pt = convert.to_torch(jax.device_get(pj))
    tok = np.random.default_rng(6).integers(0, cj.vocab, (2, 9)).astype(np.int32)
    cap = 12
    lj, cache_j = jm.prefill(pj, cj, {"tokens": jnp.asarray(tok)}, cap)
    with torch.no_grad():
        lt, cache_t = tm.prefill(pt, ct, {"tokens": torch.as_tensor(tok)}, cap)
    _close(lt, lj, "prefill")
    tj, tt = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1).to(torch.int32)
    for pos in range(9, 17):
        assert to_np(tt).tolist() == np.asarray(tj).tolist(), pos
        lj, cache_j = jm.decode_step(pj, cj, tj, jnp.int32(pos), cache_j)
        with torch.no_grad():
            lt, cache_t = tm.decode_step(pt, ct, tt, pos, cache_t)
        _close(lt, lj, f"decode at {pos}")
        tj, tt = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1).to(torch.int32)
    got, want = convert.flatten(cache_t), jax.tree_util.tree_leaves(cache_j)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, "caches after the wrap")
    # group 0 holds the dense first layer's MLA cache, group 1 the MoE layer's
    assert [sorted(c) for c in cache_t] == [["0_mla"], ["0_mla"]]
    assert isinstance(cache_t[0]["0_mla"], attn.MLACache)


def test_init_mla_cache_matches_prefill_tree():
    _, ct = _cfgs("236b")
    empty = tm.init_cache(ct, 2, 8, device="cpu")
    _, filled = tm.prefill(tm.init_params(0, ct, device="cpu"),
                           ct, {"tokens": torch.zeros(2, 5, dtype=torch.int32)}, 8)
    assert [tuple(x.shape) for x in convert.flatten(empty)] == \
           [tuple(x.shape) for x in convert.flatten(filled)]
    jc = jm.init_cache(jget_config(ARCHS["236b"], "smoke"), 2, 8)
    assert [tuple(x.shape) for x in convert.flatten(empty)] == \
           [x.shape for x in jax.tree_util.tree_leaves(jc)]
