"""The port's optimizers (`repro_torch.optim`) against the JAX package's
(`repro.optim`), on the CPU: sgd, momentum and adam step for step on the
same tree and gradients (f32 leaves atol 1e-6; a bf16 leaf to one bf16
ulp), their convergence on the quadratic of tests/test_optim_checkpoint.py,
and updates that leave the inputs untouched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import optim as joptim
from repro_torch import convert, optim
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

from _torch_parity import to_np

OPTS = {"sgd": dict(lr=0.1), "momentum": dict(lr=0.05, beta=0.9),
        "adam": dict(lr=0.1, b1=0.9, b2=0.999, eps=1e-8)}


def _tree(rng):
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "nested": {"b": [rng.standard_normal(7).astype(np.float32)]}}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_steps_match_jax(name):
    rng = np.random.default_rng(0)
    jopt, topt = getattr(joptim, name)(**OPTS[name]), getattr(optim, name)(**OPTS[name])
    pj = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    pt = convert.to_torch(_tree(np.random.default_rng(0)))
    sj, st = jopt.init(pj), topt.init(pt)
    for step in range(5):
        g = _tree(rng)
        uj, sj = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        ut, st = topt.update(convert.to_torch(g), st, pt)
        pj, pt = joptim.apply_updates(pj, uj), optim.apply_updates(pt, ut)
        for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-6, err_msg=str(step))
    for a, b in zip(tree_leaves(st), jax.tree_util.tree_leaves(sj)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_bf16_leaf_matches_jax(name):
    """A bf16 parameter: JAX keeps adam's moments in f32 and casts the
    update to the parameter's type; the port does the same."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal(64).astype(np.float32)
    pj = {"x": jnp.asarray(p, jnp.bfloat16)}
    pt = {"x": torch.as_tensor(p).to(torch.bfloat16)}
    jopt, topt = getattr(joptim, name)(**OPTS[name]), getattr(optim, name)(**OPTS[name])
    sj, st = jopt.init(pj), topt.init(pt)
    for _ in range(3):
        g = rng.standard_normal(64).astype(np.float32)
        uj, sj = jopt.update({"x": jnp.asarray(g, jnp.bfloat16)}, sj, pj)
        ut, st = topt.update({"x": torch.as_tensor(g).to(torch.bfloat16)}, st, pt)
        pj, pt = joptim.apply_updates(pj, uj), optim.apply_updates(pt, ut)
    assert pt["x"].dtype == torch.bfloat16
    want = np.asarray(pj["x"], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    assert (np.abs(to_np(pt["x"]) - want) / ulp).max() <= 1.0


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_quadratic(name):
    """The quadratic of tests/test_optim_checkpoint.py, with autograd."""
    opt = {"sgd": optim.sgd(0.1), "momentum": optim.momentum(0.05),
           "adam": optim.adam(0.1)}[name]
    target = torch.as_tensor(np.random.default_rng(0).standard_normal(8).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = opt.init(params)
    before = {k: v.clone() for k, v in params.items()}
    for i in range(200):
        leaves, td = tree_flatten(params)
        leaves = [x.requires_grad_(True) for x in leaves]
        loss = torch.sum((tree_unflatten(td, leaves)["w"] - target) ** 2)
        g = tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))
        updates, state = opt.update(g, state, params)
        new = optim.apply_updates(params, updates)
        if i == 0:  # functional: the inputs stay as they were
            assert torch.equal(params["w"].detach(), before["w"])
        params = {k: v.detach() for k, v in new.items()}
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3
