"""The port's MoE block (`repro_torch.models.moe`) against the JAX
package's, on the CPU: outputs and aux loss (atol 1e-5, rtol 1e-5) with a
roomy capacity and with one that drops choices, an exact-tie router
(lower expert index first, as `jax.lax.top_k`), gradients through the
router and the experts (atol 1e-4), and the capacity's truncation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.tree import tree_flatten, tree_unflatten

from _torch_parity import to_np

ATOL = RTOL = 1e-5
GRAD_ATOL = 1e-4


def _cfgs(**kw):
    cj = jget_config("deepseek-v2-lite-16b", "smoke").replace(**kw)
    return cj, get_config("deepseek-v2-lite-16b", "smoke").replace(**kw)


def _case(cj, seed, b=2, s=12, zero_router=False):
    params = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(seed), cj, jnp.float32))
    if zero_router:
        params = dict(params, router=np.zeros_like(params["router"]))
    x = np.random.default_rng(seed).standard_normal((b, s, cj.d_model)).astype(np.float32)
    return params, x


def _run_both(cj, ct, params, x):
    yj, auxj = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, params), cj, jnp.asarray(x))
    with torch.no_grad():
        yt, auxt = moe.moe_apply(convert.to_torch(params), ct, torch.as_tensor(x))
    return (np.asarray(yj), float(auxj)), (to_np(yt), float(auxt))


def _kept_choices(ct, params, x):
    """How many of the T*K choices the capacity keeps (from the port's
    routing, recomputed here in numpy)."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1) @ params["router"]
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :ct.moe_top_k].reshape(-1)
    cap = moe.moe_capacity(ct, t)
    seen = np.zeros(ct.n_experts, int)
    kept = 0
    for e in order:
        kept += seen[e] < cap
        seen[e] += 1
    return kept, t * ct.moe_top_k


@pytest.mark.parametrize("capacity_factor,drops", [(4.0, False), (0.5, True)])
def test_moe_apply_and_aux_match_jax(capacity_factor, drops):
    cj, ct = _cfgs(capacity_factor=capacity_factor)
    params, x = _case(cj, 3)
    kept, total = _kept_choices(ct, params, x)
    assert (kept < total) == drops  # the case drops choices or it does not
    (yj, aj), (yt, at) = _run_both(cj, ct, params, x)
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(at, aj, atol=ATOL, rtol=RTOL)


def test_exact_tie_router_takes_lowest_experts():
    """A zero router gives every expert the same probability: both packages
    route every token to experts 0..k-1, and the capacity drops the later
    tokens' choices the same way."""
    cj, ct = _cfgs(capacity_factor=1.0)
    params, x = _case(cj, 4, zero_router=True)
    (yj, aj), (yt, at) = _run_both(cj, ct, params, x)
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(at, aj, atol=ATOL, rtol=RTOL)
    # only experts 0 and 1 hold tokens: zeroing the others' weights changes nothing
    quiet = dict(params)
    for k in ("w_gate", "w_up", "w_down"):
        quiet[k] = params[k].copy()
        quiet[k][ct.moe_top_k:] = 0.0
    with torch.no_grad():
        yq, _ = moe.moe_apply(convert.to_torch(quiet), ct, torch.as_tensor(x))
    np.testing.assert_array_equal(to_np(yq), yt)


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_gradients_match_jax(capacity_factor):
    cj, ct = _cfgs(capacity_factor=capacity_factor)
    params, x = _case(cj, 5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jfn(p, xx):
        y, aux = jmoe.moe_apply(p, cj, xx)
        return jnp.sum(y * w) + aux

    gj_p, gj_x = jax.grad(jfn, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params),
                                               jnp.asarray(x))
    leaves, td = tree_flatten(convert.to_torch(params))
    leaves = [v.requires_grad_(True) for v in leaves]
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = moe.moe_apply(tree_unflatten(td, leaves), ct, xt)
    grads = torch.autograd.grad(torch.sum(y * torch.as_tensor(w)) + aux, leaves + [xt])
    jl = jax.tree_util.tree_leaves(gj_p)
    assert len(jl) == len(leaves) == 7  # router, the experts and the shared expert
    for g, want in zip(grads, jl + [gj_x]):
        np.testing.assert_allclose(to_np(g), np.asarray(want), atol=GRAD_ATOL)
    # JAX's leaf order puts the router first: the routing weights carry gradient
    assert float(grads[0].abs().max()) > 0


def test_capacity_truncates_as_jax():
    """max(1, int(T k capacity_factor / E)): deepseek-v2-lite-16b's decode
    batch of 8 tokens gets one slot an expert (int(8 * 6 * 1.25 / 64) = 0)."""
    full = get_config("deepseek-v2-lite-16b", "full")
    assert moe.moe_capacity(full, 8) == 1
    assert moe.moe_capacity(full, 4 * 128) == int(4 * 128 * 6 * 1.25 / 64) == 60
    assert moe.moe_capacity(get_config("deepseek-v2-236b", "full"), 512) == 24


def test_decode_sized_batch_drops_as_jax():
    """Two tokens at capacity 1: most choices drop, and the kept weights are
    not renormalised after the drop (JAX's code, whatever its docstring)."""
    cj, ct = _cfgs(capacity_factor=1.0, n_experts=4, moe_top_k=2)
    params, x = _case(cj, 7, b=2, s=1)
    assert moe.moe_capacity(ct, 2) == 1
    (yj, aj), (yt, at) = _run_both(cj, ct, params, x)
    np.testing.assert_allclose(yt, yj, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(at, aj, atol=ATOL, rtol=RTOL)

