"""convert.py carries JAX weights across; the configs and parameter trees
of the ported architectures match JAX's; the stablelm SMOKE `train_loss`
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


# parameters of the full configs' trees (`jax.eval_shape` of `init_params`)
FULL_PARAMS = {"stablelm-1.6b": 1438746624, "zamba2-1.2b": 1104937856,
               "mamba2-1.3b": 1343740928}


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_configs_match_jax(arch):
    for variant in ("smoke", "full"):
        cj, ct = jget_config(arch, variant), get_config(arch, variant)
        assert {f: getattr(cj, f) for f in cj.__dataclass_fields__} == \
               {f: getattr(ct, f) for f in ct.__dataclass_fields__}
        assert cj.param_count() == ct.param_count()
    assert get_config(canonical(arch)) == get_config(arch)
    full = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jget_config(arch)))
    assert sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(full)) == FULL_PARAMS[arch]
    # the port's tree at smoke size: same leaves, shapes and types as JAX's
    smoke = jinit(jax.random.PRNGKey(0), jget_config(arch, "smoke"))
    tl = convert.flatten(init_params(0, get_config(arch, "smoke"), device="cpu"))
    jl = jax.tree_util.tree_leaves(smoke)
    assert [(tuple(x.shape), str(x.dtype)) for x in jl] == \
           [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in tl]


def test_config_registry():
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


def test_convert_carries_hybrid_bf16_tree():
    """zamba2 in bf16 with two groups: top-level shared_block, f32 leaves
    (A_log, D, dt_bias) inside a bf16 tree, JAX's leaf order, exact values."""
    cfg = jget_config("zamba2-1.2b", "smoke").replace(n_layers=3, dtype="bfloat16")
    params_j = jinit(jax.random.PRNGKey(2), cfg)
    tparams = convert.to_torch(jax.device_get(params_j))
    assert set(tparams) == {"embed", "final_norm", "groups", "shared_block"}
    assert len(tparams["groups"]) == 2
    jl = jax.tree_util.tree_leaves(params_j)
    tl = convert.flatten(tparams)
    assert {str(x.dtype) for x in jl} == {"bfloat16", "float32"}
    for a, b in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a, np.float32), to_np(b))
    ported = convert.flatten(init_params(0, get_config("zamba2-1.2b", "smoke").replace(
        n_layers=3, dtype="bfloat16"), device="cpu"))
    assert [(x.shape, x.dtype) for x in ported] == [(x.shape, x.dtype) for x in tl]


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
    """What the port does not carry yet raises instead of running: MoE, MLA,
    the split SSM projections and untied embeddings."""
    dense = get_config("stablelm-1.6b", "smoke")
    cases = {
        "moe": dense.replace(arch_type="moe", n_experts=4, moe_top_k=2, d_ff_expert=32),
        "MLA": dense.replace(use_mla=True, kv_lora=32, rope_head_dim=8, v_head_dim=16),
        "ssm_split_proj": get_config("mamba2-1.3b", "smoke").replace(ssm_split_proj=True),
        "untied": dense.replace(tie_embeddings=False),
    }
    for match, cfg in cases.items():
        with pytest.raises(NotImplementedError, match=match):
            init_params(0, cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            train_loss({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


def test_kernel_flags_run_forward_and_refuse_grad(smoke):
    """use_flash takes the flash wrapper (its plain version on the CPU): the
    loss matches the plain route, and a gradient through it is refused, as
    JAX's grad through the Pallas kernel fails."""
    cfg_j, params_j, toks = smoke
    cfg_t = get_config("stablelm-1.6b", "smoke")
    tparams = convert.to_torch(jax.device_get(params_j))
    batch = {"tokens": torch.as_tensor(toks)}
    with torch.no_grad():
        plain = train_loss(tparams, cfg_t, batch)
        flash = train_loss(tparams, cfg_t.replace(use_flash=True), batch)
    np.testing.assert_allclose(float(flash), float(plain), rtol=1e-5)
    np.testing.assert_allclose(
        float(flash), float(jloss(params_j, cfg_j.replace(use_flash=True),
                                  {"tokens": jnp.asarray(toks)})), rtol=1e-5)
    leaves, treedef = tree_flatten(tparams)
    grad_params = tree_unflatten(treedef, [x.clone().requires_grad_(True) for x in leaves])
    with pytest.raises(RuntimeError, match="forward only"):
        train_loss(grad_params, cfg_t.replace(use_flash=True), batch)
