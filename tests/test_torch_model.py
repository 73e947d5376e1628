"""convert.py carries JAX weights across; the configs and parameter trees
of all ten architectures match JAX's; the stablelm SMOKE `train_loss` and
its gradients match JAX's (rtol 1e-5 on the loss, atol 1e-5 on the
gradients, f32); so do every architecture's smoke variant (train_loss,
gradients at atol 1e-4, prefill and greedy decode at atol 1e-5 with
identical tokens), untied embeddings, and both remat policies against no
remat (equal losses and gradients)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_arch_names as jall_arch_names, get_config as jget_config
from repro.models import model as jm
from repro.models.model import init_params as jinit, train_loss as jloss
from repro_torch import convert
from repro_torch.configs import all_arch_names, canonical, get_config
from repro_torch.models import model as tm
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
               "mamba2-1.3b": 1343740928, "qwen3-14b": 13990394880,
               "minitron-4b": 4309847040, "internvl2-2b": 1701695488,
               "musicgen-large": 3225618432, "deepseek-v2-lite-16b": 15496769024,
               "yi-34b": 33930165248, "deepseek-v2-236b": 235217146880}


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
    assert sorted(all_arch_names()) == sorted(jall_arch_names()) == sorted(FULL_PARAMS)
    assert [canonical(a) for a in all_arch_names()] == \
           [canonical(a) for a in jall_arch_names()]
    assert get_config("yi-34b").name == "yi-34b"
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


def test_unported_surfaces_raise(tmp_path, monkeypatch, capsys):
    """The surfaces this test once found refused now run: both trainers take
    --compile-cache (the kernels' build directory) and the modules of the
    JAX package's shape policies, dry run, mesh and sharding import."""
    import importlib

    from repro_torch.kernels import _build
    from repro_torch.launch import serve_train, train

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    small = ["--arch", "stablelm-1.6b", "--device", "cpu", "--layers", "1", "--nodes", "2",
             "--batch", "1", "--seq", "8", "--steps", "1", "--chunk", "1"]
    for main, tag, extra in ((train.main, "train", []),
                             (serve_train.main, "serve-train",
                              ["--prompt-len", "4", "--gen", "2", "--serve-batch", "1"])):
        cache = tmp_path / tag
        main(small + extra + ["--compile-cache", str(cache)])
        assert f"[{tag}] compilation cache at {cache}" in capsys.readouterr().out
        assert _build.BUILD_DIR == cache.resolve() and cache.is_dir()
    for name in ("repro_torch.configs.shapes", "repro_torch.launch.dryrun",
                 "repro_torch.launch.mesh", "repro_torch.sharding"):
        importlib.import_module(name)
    # the names a scan of JAX's modules found missing in the port
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import attention

    assert attention.mask_is_plain(get_config("stablelm-1.6b", "smoke"), 4096) is True
    assert callable(mesh.make_logical_mesh) and callable(mesh.make_production_mesh)
    assert os.path.basename(dryrun.ARTIFACTS) == "dryrun"
    assert callable(dryrun.collective_bytes)


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


def _smoke_batch(cfg, b=2, s=16, seed=0):
    """tests/test_models_smoke.py's batch (random patch embeddings for vlm)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.arch_type == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.vision_dim)).astype(np.float32)
    return batch


def _loss_grads(params, cfg, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().clone().requires_grad_(True) for x in leaves]
    loss = train_loss(tree_unflatten(treedef, leaves), cfg,
                      {k: torch.as_tensor(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_smoke_arch_matches_jax(arch):
    """tests/test_models_smoke.py's two cases, each against JAX: train_loss
    and its gradients, then prefill and greedy decode steps (a vlm's
    positions start after its patches)."""
    cj, ct = jget_config(arch, "smoke"), get_config(arch, "smoke")
    pj = jinit(jax.random.PRNGKey(0), cj)
    pt = convert.to_torch(jax.device_get(pj))
    batch = _smoke_batch(cj, s=32)
    lj, gj = jax.value_and_grad(
        lambda p: jloss(p, cj, {k: jnp.asarray(v) for k, v in batch.items()}))(pj)
    lt, gt = _loss_grads(pt, ct, batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    jl = jax.tree_util.tree_leaves(gj)
    assert len(gt) == len(jl)
    for g, w in zip(gt, jl):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4)

    b, s = 2, 16
    batch = _smoke_batch(cj, b, s)
    cap = s + 4 + (cj.n_patches if cj.arch_type == "vlm" else 0)
    lgj, cache_j = jm.prefill(pj, cj, {k: jnp.asarray(v) for k, v in batch.items()}, cap)
    with torch.no_grad():
        lgt, cache_t = tm.prefill(pt, ct, {k: torch.as_tensor(v) for k, v in batch.items()}, cap)
    assert tuple(lgt.shape) == (b, cj.vocab)
    np.testing.assert_allclose(to_np(lgt), np.asarray(lgj), atol=1e-5)
    pos = s + (cj.n_patches if cj.arch_type == "vlm" else 0)
    tj, tt = jnp.argmax(lgj, -1).astype(jnp.int32), torch.argmax(lgt, -1).to(torch.int32)
    for i in range(3):
        assert to_np(tt).tolist() == np.asarray(tj).tolist(), i
        lgj, cache_j = jm.decode_step(pj, cj, tj, jnp.int32(pos + i), cache_j)
        with torch.no_grad():
            lgt, cache_t = tm.decode_step(pt, ct, tt, pos + i, cache_t)
        np.testing.assert_allclose(to_np(lgt), np.asarray(lgj), atol=1e-5, err_msg=str(i))
        tj, tt = jnp.argmax(lgj, -1).astype(jnp.int32), torch.argmax(lgt, -1).to(torch.int32)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b"])
def test_untied_embeddings_match_jax(arch):
    """tie_embeddings=False: an ``lm_head`` [d, vocab] leaf, in JAX's leaf
    order, scores the logits; loss and gradients as JAX's."""
    cj = jget_config(arch, "smoke").replace(tie_embeddings=False)
    ct = get_config(arch, "smoke").replace(tie_embeddings=False)
    pj = jinit(jax.random.PRNGKey(4), cj)
    pt = convert.to_torch(jax.device_get(pj))
    assert tuple(pt["lm_head"].shape) == (ct.d_model, ct.vocab)
    assert [tuple(x.shape) for x in convert.flatten(init_params(0, ct, device="cpu"))] == \
           [x.shape for x in jax.tree_util.tree_leaves(pj)]
    batch = _smoke_batch(cj, s=24, seed=1)
    lj, gj = jax.value_and_grad(
        lambda p: jloss(p, cj, {k: jnp.asarray(v) for k, v in batch.items()}))(pj)
    lt, gt = _loss_grads(pt, ct, batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for g, w in zip(gt, jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4)
    # the head is its own leaf: the embedding's gradient differs from a tied run
    _, tied = _loss_grads(convert.to_torch(jax.device_get(
        {k: v for k, v in pj.items() if k != "lm_head"})), ct.replace(tie_embeddings=True), batch)
    assert not torch.equal(tied[0], gt[0])


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b", "zamba2-1.2b"])
def test_remat_changes_no_number(arch, policy):
    """Checkpointed layers recompute in the backward exactly what the
    forward computed: the same loss and gradients as without remat, bit
    for bit on the CPU."""
    cfg = get_config(arch, "smoke")
    params = init_params(3, cfg, device="cpu")
    batch = _smoke_batch(cfg, s=24, seed=2)
    l0, g0 = _loss_grads(params, cfg, batch)
    l1, g1 = _loss_grads(params, cfg.replace(remat=True, remat_policy=policy), batch)
    assert float(l1) == float(l0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_remat_policies_keep_what_they_say():
    """"full" keeps a layer's input only; "dots" also keeps the outputs of
    the plain matrix products (aten.mm), so its backward recomputes fewer
    of them: count the mm calls in forward + backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    cfg = get_config("stablelm-1.6b", "smoke")
    params = init_params(3, cfg, device="cpu")
    batch = _smoke_batch(cfg, s=8)
    counts = {}
    for name, c in (("none", cfg), ("full", cfg.replace(remat=True)),
                    ("dots", cfg.replace(remat=True, remat_policy="dots"))):
        with CountMM() as mode:
            _loss_grads(params, c, batch)
        counts[name] = mode.mm
    assert counts["none"] == counts["dots"] < counts["full"], counts
    with pytest.raises(ValueError, match="remat_policy"):
        _loss_grads(params, cfg.replace(remat=True, remat_policy="some"), batch)


@pytest.mark.parametrize("arch,kw", [
    ("deepseek-v2-236b", {}),
    ("internvl2-2b", {"tie_embeddings": False}),
    ("mamba2-1.3b", {"ssm_split_proj": True}),
])
def test_convert_carries_new_leaves_bitwise(arch, kw):
    """The MLA (with q_lora), MoE, lm_head, vision_proj and split-SSM leaves
    in bf16: JAX's sorted-key order, the port's own tree, values bit for bit."""
    cj = jget_config(arch, "smoke").replace(dtype="bfloat16", **kw)
    pj = jinit(jax.random.PRNGKey(6), cj)
    jl = jax.tree_util.tree_leaves(pj)
    tl = convert.flatten(convert.to_torch(jax.device_get(pj)))
    for a, b in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                          b.view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ported = convert.flatten(init_params(0, get_config(arch, "smoke").replace(
        dtype="bfloat16", **kw), device="cpu"))
    assert [(tuple(x.shape), x.dtype) for x in ported] == [(tuple(x.shape), x.dtype) for x in tl]
