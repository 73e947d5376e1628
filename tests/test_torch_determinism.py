"""Same seed, same bits: the parts of the port that made two training runs
from one seed differ on the card, checked on the CPU.

  * the MoE layer's dispatch and combine, now sums in a fixed order (a
    token's k weighted outputs added choice by choice over a [T, k, d]
    view, each kept choice in a slot of its own, the token repeated by an
    expand), against the scatter form it replaced and against JAX, at
    tests/test_torch_moe.py's tolerances;
  * the convolution scope (`cnn._ieee_fp32`, entered by `_Conv2dIEEE` in
    the forward and in autograd's later backward) pins cuDNN's
    deterministic algorithms with its autotuner off, besides TF32 off,
    and restores all three after;
  * the entry points (`run_pame`, `bind(...).run` / `make_runner`,
    `bind_batched(...).run`, the trainer CLI) leave no global switch
    changed after they return: no process-wide determinism switch is
    needed or set.

The runs on the card themselves (two runs from one seed equal bit for
bit) are the `cuda`-marked tests of tests/test_torch_cuda_kernels.py and
the chip smoke's repeat phase.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import algorithms as ALG  # noqa: E402
from repro_torch.core import build_topology, run_pame  # noqa: E402
from repro_torch.core.pame import PaMEConfig  # noqa: E402
from repro_torch.core.scenarios import Scenario  # noqa: E402
from repro_torch.models import cnn as T  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import linear  # noqa: E402
from repro_torch.tree import tree_flatten, tree_unflatten  # noqa: E402

from _torch_parity import one_torch_thread, to_np  # noqa: E402,F401

ATOL = RTOL = 1e-5      # tests/test_torch_moe.py's output tolerance
GRAD_ATOL = 1e-4        # and its gradient tolerance

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _scatter_moe(params, cfg, x):
    """The MoE layer as the port computed it before: dispatch and combine
    by `index_add` over (token, choice) rows gathered with `xf[tok_of]`
    (sums whose order the card does not fix)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    xf = x.reshape(t, d)
    logits = linear(xf, params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    capacity = moe.moe_capacity(cfg, t)
    expert_of = top_i.reshape(t * k)
    flat_oh = F.one_hot(expert_of, e)
    slot = (torch.cumsum(flat_oh, dim=0) - flat_oh).gather(1, expert_of[:, None])[:, 0]
    keep = slot < capacity
    dest = expert_of * capacity + torch.clamp(slot, max=capacity - 1)
    tok_of = torch.arange(t).repeat_interleave(k)
    contrib = torch.where(keep[:, None], xf[tok_of], torch.zeros((), dtype=xf.dtype))
    buf = torch.zeros((e * capacity, d), dtype=xf.dtype).index_add(
        0, dest, contrib).reshape(e, capacity, d)
    h = F.silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf, params["w_up"])
    out_buf = torch.bmm(h, params["w_down"]).reshape(e * capacity, d)
    weight = torch.where(keep, top_p.reshape(t * k), 0.0)
    y = torch.zeros((t, d), dtype=xf.dtype).index_add(
        0, tok_of, out_buf[dest] * weight[:, None].to(xf.dtype))
    if cfg.n_shared_experts:
        sp = params["shared"]
        y = y + linear(F.silu(linear(xf, sp["w_gate"])) * linear(xf, sp["w_up"]), sp["w_down"])
    return y.reshape(b, s, d)


def _grads(fn, params, x, w):
    leaves, td = tree_flatten(params)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    xt = x.clone().requires_grad_(True)
    y = fn(tree_unflatten(td, leaves), xt)
    return y.detach(), torch.autograd.grad(torch.sum(y * w), leaves + [xt])


@pytest.mark.parametrize("capacity_factor", [4.0, 0.5])
def test_moe_fixed_order_combine_matches_scatter_form_and_jax(capacity_factor):
    """The fixed-order dispatch and combine give the scatter form's output
    and gradients and JAX's, at the MoE tests' tolerances; with a capacity
    that drops choices too (0.5)."""
    cj = jget_config("deepseek-v2-lite-16b", "smoke").replace(capacity_factor=capacity_factor)
    ct = get_config("deepseek-v2-lite-16b", "smoke").replace(capacity_factor=capacity_factor)
    pj = jax.device_get(jmoe.moe_init(jax.random.PRNGKey(5), cj, jnp.float32))
    x = np.random.default_rng(5).standard_normal((2, 12, cj.d_model)).astype(np.float32)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    params, xt, wt = convert.to_torch(pj), torch.as_tensor(x), torch.as_tensor(w)
    y_new, g_new = _grads(lambda p, xx: moe.moe_apply(p, ct, xx)[0], params, xt, wt)
    y_old, g_old = _grads(lambda p, xx: _scatter_moe(p, ct, xx), params, xt, wt)
    np.testing.assert_allclose(to_np(y_new), to_np(y_old), atol=ATOL, rtol=RTOL)
    for a, b in zip(g_new, g_old):
        np.testing.assert_allclose(to_np(a), to_np(b), atol=GRAD_ATOL)

    def jfn(p, xx):
        return jnp.sum(jmoe.moe_apply(p, cj, xx)[0] * w)

    yj = jmoe.moe_apply(jax.tree_util.tree_map(jnp.asarray, pj), cj, jnp.asarray(x))[0]
    np.testing.assert_allclose(to_np(y_new), np.asarray(yj), atol=ATOL, rtol=RTOL)
    gj_p, gj_x = jax.grad(jfn, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, pj),
                                               jnp.asarray(x))
    for g, want in zip(g_new, jax.tree_util.tree_leaves(gj_p) + [gj_x]):
        np.testing.assert_allclose(to_np(g), np.asarray(want), atol=GRAD_ATOL)


def test_moe_repeats_bit_for_bit():
    """Two forward and backward passes from the same inputs are equal."""
    ct = get_config("deepseek-v2-lite-16b", "smoke").replace(capacity_factor=0.5)
    params = moe.moe_init(torch.Generator().manual_seed(3), ct, torch.float32)
    x = torch.randn((2, 12, ct.d_model), generator=torch.Generator().manual_seed(4))
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    (y1, g1), (y2, g2) = (_grads(lambda p, xx: moe.moe_apply(p, ct, xx)[0], params, x, w)
                          for _ in range(2))
    assert torch.equal(y1, y2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def _flags():
    cudnn = torch.backends.cudnn
    return (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)


def test_conv_scope_pins_deterministic_cudnn_and_restores(monkeypatch):
    """Inside every convolution's scope, forward and backward, cuDNN runs
    with TF32 off, deterministic algorithms on and the autotuner off; the
    three flags are the caller's again after each scope and after the
    backward."""
    real = T._ieee_fp32
    inside = []

    def recording():
        ctx = real()

        class Scope:
            def __enter__(self):
                ctx.__enter__()
                inside.append(_flags())

            def __exit__(self, *exc):
                return ctx.__exit__(*exc)

        return Scope()

    monkeypatch.setattr(T, "_ieee_fp32", recording)
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    monkeypatch.setattr(cudnn, "deterministic", False)
    monkeypatch.setattr(cudnn, "benchmark", True)
    params = T.cnn_init(0)
    x = torch.randn((2, 28, 28, 1), generator=torch.Generator().manual_seed(7))
    leaves, treedef = tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    loss = T.ce_loss(T.cnn_apply(tree_unflatten(treedef, leaves), x),
                     torch.tensor([1, 2], dtype=torch.int32))
    assert inside == [(False, True, False)] * 2
    assert _flags() == (True, False, True)
    torch.autograd.grad(loss, leaves)
    assert inside == [(False, True, False)] * 4  # one scope per convolution's backward
    assert _flags() == (True, False, True)


def _switches():
    cudnn = torch.backends.cudnn
    return (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())


def _cnn_task(m=4, per_node=4):
    """A tiny CNN problem: per-node batches of 28x28 images, ce_loss."""
    g = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn((m, per_node, 28, 28, 1), generator=g),
             "y": torch.randint(0, 10, (m, per_node), generator=g, dtype=torch.int32)}

    def grad_fn(params, b, key):
        leaves, td = tree_flatten(params)
        loss = T.ce_loss(T.cnn_apply(params, b["x"]), b["y"])
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    return batch, grad_fn


def test_entry_points_leave_no_switch_changed(tmp_path):
    """run_pame, a bound registry run and runner, a batched grid under a
    scenario and the trainer CLI, each twice from one seed: the two runs
    agree bit for bit and every global switch (cuDNN's TF32, deterministic
    and autotuner flags, matmul TF32, torch's deterministic mode) is what
    it was before."""
    from repro_torch.launch import train

    before = _switches()
    batch, grad_fn = _cnn_task()
    topo = build_topology("complete", 4)
    p0 = T.cnn_init(1)
    cfg = PaMEConfig(nu=0.5, p=0.3, gamma=1.01, sigma0=4.0, kappa_lo=1, kappa_hi=1)
    dpsgd = ALG.get_algorithm("dpsgd").bind(grad_fn, topo, ALG.DPSGDHp(lr=0.05), device="cpu")
    grid = ALG.get_algorithm("pame").bind_batched(
        grad_fn, topo, [ALG.PaMEHp(nu=0.5, p=0.3, gamma=1.01, sigma0=4.0)], seeds=[0, 1],
        scenario=Scenario(name="flaky", churn=0.1, edge_drop=0.2, seed=5), device="cpu")
    runs = {
        "run_pame": lambda: run_pame(0, p0, 4, grad_fn, lambda k: batch, topo, cfg,
                                     num_steps=2, tol_std=0.0, device="cpu")[0].params,
        "bind.run": lambda: dpsgd.run(0, p0, 4, lambda k: batch, 2, tol_std=0.0)[0].params,
        "make_runner": lambda: dpsgd.make_runner(tol_std=0.0)(
            0, p0, 4, lambda k: batch, 2)[0].params,
        "bind_batched.run": lambda: grid.run(p0, 4, lambda k: batch, 2, tol_std=0.0)[0].params,
        "train.main": lambda: train.main([
            "--arch", "deepseek-v2-lite-16b", "--variant", "smoke", "--layers", "2",
            "--nodes", "4", "--batch", "1", "--seq", "16", "--steps", "2", "--chunk", "1",
            "--device", "cpu"], return_state=True)["state"].params,
    }
    for name, run in runs.items():
        first, second = run(), run()
        for a, b in zip(tree_flatten(first)[0], tree_flatten(second)[0]):
            assert torch.equal(a, b), name
        assert _switches() == before, name


def test_chip_smoke_path_r_rehearsal(capsys):
    """`chip_smoke.py`'s repeat phase (F3, F4, I1 and H2dyn-L5, each twice
    from one seed) and its resume on the card (a checkpoint midway, then
    the resumed run against the uninterrupted one) at tiny sizes on the
    CPU: every pair equal leaf for leaf, no switch left on."""
    import concurrent.futures
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cpu = torch.device("cpu")
    cs.HELD = 128
    data = {}
    for key, sp in (("F3", dict(cs.FMNIST, n=1024)), ("F4", dict(cs.CIFAR, n=768))):
        data[key] = concurrent.futures.Future()
        data[key].set_result(cs.images(sp))
    rows, launches = cs.path_repeat(cpu, data, steps=dict(cnn=2, resnet=1, dynamic=2),
                                    i1_variant="smoke", i1_layers=2)
    assert set(rows) == {"F3-pame", "F4-pame", "I1", f"H2dyn-L{cs.H_SEEDS}"}
    assert all(r["equal"] and not any(r["switches"]) for r in rows.values())
    resume = cs.path_resume(cpu, argv=["--arch", "stablelm-1.6b", "--variant", "smoke",
                                       "--layers", "1", "--nodes", "4", "--batch", "1",
                                       "--seq", "16", "--chunk", "1"], steps=4, at=2)
    assert resume["equal"] and resume["start"] == 2 and resume["save"][0]["step"] == 2
    out = capsys.readouterr().out
    assert '"phase": "path_repeat"' in out and '"phase": "path_resume"' in out
