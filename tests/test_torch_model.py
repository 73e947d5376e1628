"""convert.py carries JAX weights across; the stablelm SMOKE `train_loss`
and its gradients match JAX's (rtol 1e-5 on the loss, atol 1e-5 on the
gradients, f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.models.model import init_params as jinit, train_loss as jloss
from repro_torch import convert
from repro_torch.configs import canonical, get_config
from repro_torch.models.model import init_params, train_loss
from repro_torch.tree import tree_flatten, tree_unflatten

from _torch_parity import to_np


@pytest.fixture(scope="module")
def smoke():
    cfg_j = jget_config("stablelm-1.6b", "smoke")
    params_j = jinit(jax.random.PRNGKey(0), cfg_j)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (2, 24)).astype(np.int32)
    return cfg_j, params_j, toks


def test_configs_match_jax():
    for variant in ("smoke", "full"):
        cj, ct = jget_config("stablelm-1.6b", variant), get_config("stablelm-1.6b", variant)
        assert {f: getattr(cj, f) for f in cj.__dataclass_fields__} == \
               {f: getattr(ct, f) for f in ct.__dataclass_fields__}
        assert cj.param_count() == ct.param_count()
    assert canonical("stablelm-1.6b") == "stablelm_1p6b"
    with pytest.raises(ValueError, match="not yet ported"):
        get_config("yi-34b")
    with pytest.raises(ValueError, match="unknown"):
        get_config("gpt-17")


def test_convert_keeps_tree_order_and_values(smoke):
    _, params_j, _ = smoke
    tparams = convert.to_torch(jax.device_get(params_j))
    jl, _ = jax.tree_util.tree_flatten(params_j)
    tl = convert.flatten(tparams)
    assert len(jl) == len(tl) == 11
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a), to_np(b))
    bf = convert.to_torch({"x": np.asarray(jnp.arange(5, dtype=jnp.bfloat16))})
    assert bf["x"].dtype == torch.bfloat16 and bf["x"].tolist() == [0, 1, 2, 3, 4]


def test_init_params_tree_matches_jax(smoke):
    cfg_j, params_j, _ = smoke
    tparams = init_params(0, get_config("stablelm-1.6b", "smoke"), device="cpu")
    jl = jax.tree_util.tree_leaves(params_j)
    tl = convert.flatten(tparams)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    full = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jget_config("stablelm-1.6b")))
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(full)) == 1438746624


def test_train_loss_and_grads_match_jax(smoke):
    cfg_j, params_j, toks = smoke
    cfg_t = get_config("stablelm-1.6b", "smoke")
    lj, gj = jax.value_and_grad(lambda p: jloss(p, cfg_j, {"tokens": jnp.asarray(toks)}))(params_j)
    tparams = convert.to_torch(jax.device_get(params_j))
    leaves, treedef = tree_flatten(tparams)
    leaves = [x.requires_grad_(True) for x in leaves]
    lt = train_loss(tree_unflatten(treedef, leaves), cfg_t,
                    {"tokens": torch.as_tensor(toks)})
    grads = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-5)


def test_unported_model_paths_raise():
    cfg = get_config("stablelm-1.6b", "smoke")
    with pytest.raises(NotImplementedError, match="flash_attention"):
        params = init_params(0, cfg, device="cpu")
        train_loss(params, cfg.replace(use_flash=True),
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        init_params(0, cfg.replace(arch_type="ssm"), device="cpu")
