"""The paper's own tasks on the port against the JAX package: three PaME
steps of the Example-3 CNN under label skew with JAX's draws injected (the
dense exact exchange of the example's config), two registry steps of
D-PSGD on ResNet-20 under Dirichlet skew, and two registry steps of the
tree-partitioned PaME exchange with per-leaf rates and Bernoulli masks
(the wide-CNN benchmark's config), every state leaf and metric at rtol
1e-5 / atol 1e-5; the port's own convergence on the CNN under label skew
(tests/test_integration.py's bound, loss[-1] < 0.7 loss[0]); both port
examples run on the CPU, and refuse to run without a card unless asked
for the CPU."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import algorithms as JALG
from repro.core import pame as jpame
from repro.core.topology import build_topology as jbuild
from repro.data import NodeBatcher, SyntheticClassification, dirichlet_partition
from repro.data import label_skew_partition
from repro.models import cnn as J
from repro_torch import convert
from repro_torch.core import algorithms as TALG
from repro_torch.core import pame as tpame
from repro_torch.core.topology import build_topology as tbuild
from repro_torch.models import cnn as T
from repro_torch.tree import tree_flatten, tree_unflatten

from _torch_parity import assert_history_matches, bound_parity, jax_step_draws, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-5
M = 4
# the example's PaME config (examples/cnn_heterogeneity.py)
EX3 = dict(nu=0.7, p=0.3, gamma=1.002, sigma0=10.0, kappa_lo=2, kappa_hi=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops a step: beside other test workers, torch's
    intra-op threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _grads(japply, tapply):
    def jg(p, b, key):
        return jax.value_and_grad(lambda q: J.ce_loss(japply(q, b["x"]), b["y"]))(p)

    def tg(p, b, key):
        leaves, treedef = tree_flatten(p)
        loss = T.ce_loss(tapply(p, b["x"]), b["y"])
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))

    return jg, tg


def _batch(ds, parts, batch, seed=0):
    """One node-stacked batch, as numpy, and as each package takes it."""
    b = NodeBatcher({"x": ds.images, "y": ds.labels}, parts, batch_size=batch, seed=seed).next()
    return ({"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])},
            {"x": torch.as_tensor(b["x"]), "y": torch.as_tensor(b["y"])})


def _stacked(params, seed):
    """m distinct node models around `params` (numpy leaves [m, ...])."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x)[None] + 0.05 * rng.standard_normal((M,) + x.shape)
                   ).astype(np.float32), params)


def _t_cfg(cfg):
    return tpame.PaMEConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def test_pame_cnn_label_skew_steps_match_jax():
    """Three steps of Algorithm 1 on the CNN, 4 nodes at C = 7, each with a
    fresh batch; steps 0-2 mix communicating and silent receivers."""
    ds = SyntheticClassification.make(512, (28, 28, 1), 10, seed=0, sep=3.0)
    parts = label_skew_partition(ds.labels, M, 7, seed=0)
    cfg = jpame.PaMEConfig(**EX3)
    topo = jbuild("complete", M)
    ta_j = jpame.make_topology_arrays(topo, cfg, seed=0)
    ta_t = tpame.make_topology_arrays(tbuild("complete", M), _t_cfg(cfg), seed=0, device="cpu")
    stacked = _stacked(J.cnn_init(jax.random.PRNGKey(1)), 0)
    key = jax.random.PRNGKey(0)
    sj = jpame.pame_init(key, jax.tree_util.tree_map(jnp.asarray, stacked), M, cfg)
    st = tpame.pame_init(0, convert.to_torch(stacked), M, _t_cfg(cfg))
    jg, tg = _grads(J.cnn_apply, T.cnn_apply)
    step_j = jax.jit(lambda s, b: jpame.pame_step(s, b, jg, ta_j, cfg))
    nb = NodeBatcher({"x": ds.images, "y": ds.labels}, parts, batch_size=8, seed=0)
    comm = []
    for k in range(3):
        b = nb.next()
        draws = jax_step_draws(key, k, sj.params, ta_j, cfg)
        sj, mj = step_j(sj, {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"])})
        st, mt = tpame.pame_step(st, {"x": torch.as_tensor(b["x"]), "y": torch.as_tensor(b["y"])},
                                 tg, ta_t, _t_cfg(cfg), draws=draws)
        for g, w in zip(tree_flatten(st.params)[0], jax.tree_util.tree_leaves(sj.params)):
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {k}")
        for name in ("loss_mean", "consensus", "comm_nodes", "sigma_mean"):
            np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=RTOL,
                                       err_msg=f"step {k} {name}")
        comm.append(int(mj["comm_nodes"]))
    assert comm[0] == M and min(comm) < M


def test_run_pame_cnn_history_matches_jax():
    """`run_pame` on Example 3 against JAX's (scan drivers, chunks of 2,
    JAX's draws injected through ``draws_fn``): the history over the
    reference's keys and the final parameters, at 1e-5."""
    ds = SyntheticClassification.make(384, (28, 28, 1), 10, seed=0, sep=3.0)
    parts = label_skew_partition(ds.labels, M, 7, seed=0)
    cfg = jpame.PaMEConfig(**EX3)
    jg, tg = _grads(J.cnn_apply, T.cnn_apply)
    batches = [NodeBatcher({"x": ds.images, "y": ds.labels}, parts, batch_size=4, seed=0).next()
               for _ in range(4)]
    p0 = jax.device_get(J.cnn_init(jax.random.PRNGKey(1)))
    jstate, jhist = jpame.run_pame(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, p0), M, jg,
        lambda k: jax.tree_util.tree_map(jnp.asarray, batches[k]), jbuild("complete", M), cfg,
        num_steps=4, tol_std=0.0, chunk_size=2)
    ta_j = jpame.make_topology_arrays(jbuild("complete", M), cfg, seed=0)
    template = jax.tree_util.tree_map(lambda x: jnp.zeros((M,) + x.shape), p0)
    tstate, thist = tpame.run_pame(
        0, convert.to_torch(p0), M, tg,
        lambda k: {key: torch.as_tensor(v) for key, v in batches[k].items()},
        tbuild("complete", M), _t_cfg(cfg), num_steps=4, tol_std=0.0, chunk_size=2,
        device="cpu",
        draws_fn=lambda step: jax_step_draws(jax.random.PRNGKey(0), step, template, ta_j, cfg))
    assert_history_matches(thist, jhist, rtol=RTOL, atol=ATOL)
    for g, w in zip(tree_flatten(tstate.params)[0], jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_registry_dpsgd_resnet20_dirichlet_steps_match_jax():
    """Two registry steps of D-PSGD (sparse mixing) on ResNet-20, 4 nodes
    under Dirichlet(0.3) skew, in float64 on both sides.  In f32 the two
    frameworks' convolution sums differ by ~1e-6 relative, and over 20 ReLU
    layers and 4 nodes some pre-activation lies closer to 0 than that: its
    sign flips between the frameworks and moves the stage-1 gradients by
    ~0.4 % (found at step 1 of this data), which no f32 tolerance on a
    multi-step run can hold.  f32 parity of one forward and backward is
    tests/test_torch_cnn.py's."""
    ds = SyntheticClassification.make(256, (32, 32, 3), 10, seed=1, sep=2.0)
    parts = dirichlet_partition(ds.labels, M, 0.3, seed=0)
    jg, tg = _grads(J.resnet20_apply, T.resnet20_apply)
    f64 = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)  # noqa: E731
    stacked = f64(_stacked(J.resnet20_init(jax.random.PRNGKey(1)), 1))
    with jax.enable_x64(True):
        jb, tb = _batch(ds, parts, 4)
        jb["x"], tb["x"] = jb["x"].astype(jnp.float64), tb["x"].double()
        jbound = JALG.get_algorithm("dpsgd").bind(jg, jbuild("complete", M),
                                                  JALG.DPSGDHp(lr=0.05), mixing="sparse")
        tbound = TALG.get_algorithm("dpsgd").bind(tg, tbuild("complete", M),
                                                  TALG.DPSGDHp(lr=0.05), mixing="sparse",
                                                  device="cpu")
        out = bound_parity("dpsgd", jbound, tbound, jax.tree_util.tree_map(jnp.asarray, stacked),
                           convert.to_torch(stacked), jb, tb, 2, rtol=RTOL, atol=ATOL)
    assert all(float(mt["loss_mean"]) > 0 for _, mt in out)


def test_registry_tree_partition_pame_cnn_steps_match_jax():
    """Two registry steps of PaME with the wide-CNN benchmark's exchange:
    per-leaf segments, p_leaf over (b1, b2, c1, c2, fc1, fc2), Bernoulli
    masks, sparse mixing; C = 3, width 1."""
    ds = SyntheticClassification.make(256, (28, 28, 1), 10, seed=0, sep=3.0)
    parts = label_skew_partition(ds.labels, M, 3, seed=0)
    jb, tb = _batch(ds, parts, 4)
    jg, tg = _grads(J.cnn_apply, T.cnn_apply)
    kw = dict(EX3, mask_mode="bernoulli", partition="tree",
              p_leaf=(1.0, 1.0, 0.8, 0.4, 0.15, 0.8))
    stacked = _stacked(J.cnn_init(jax.random.PRNGKey(1)), 2)
    jbound = JALG.get_algorithm("pame").bind(jg, jbuild("complete", M), JALG.PaMEHp(**kw),
                                             mixing="sparse")
    tbound = TALG.get_algorithm("pame").bind(tg, tbuild("complete", M), TALG.PaMEHp(**kw),
                                             mixing="sparse", device="cpu")
    bound_parity("pame", jbound, tbound, jax.tree_util.tree_map(jnp.asarray, stacked),
                 convert.to_torch(stacked), jb, tb, 2, rtol=RTOL, atol=ATOL)
    assert tbound.wire_bits_for(T.cnn_init(0)) == jbound.wire_bits_for(
        J.cnn_init(jax.random.PRNGKey(1)))


def test_pame_dfl_on_cnn_heterogeneous():
    """The port's own run of tests/test_integration.py's convergence case:
    a tiny non-IID CNN federation, 60 PaME steps."""
    from repro_torch.core import PaMEConfig, build_topology, run_pame
    from repro_torch.data import NodeBatcher as TBatcher
    from repro_torch.data import SyntheticClassification as TData
    from repro_torch.data import label_skew_partition as t_label_skew

    ds = TData.make(512, (28, 28, 1), 10, seed=0, sep=3.0)
    parts = t_label_skew(ds.labels, M, classes_per_node=5, seed=0)
    nb = TBatcher({"x": ds.images, "y": ds.labels}, parts, batch_size=16, seed=0)
    cfg = PaMEConfig(nu=0.7, p=0.3, gamma=1.002, sigma0=10.0, homogeneous_kappa=2)
    _, tg = _grads(J.cnn_apply, T.cnn_apply)

    def batch_fn(k):
        b = nb.next()
        return {"x": torch.as_tensor(b["x"]), "y": torch.as_tensor(b["y"])}

    _, hist = run_pame(1, T.cnn_init(0), M, tg, batch_fn, build_topology("complete", M), cfg,
                       num_steps=60, tol_std=0.0, device="cpu")
    losses = hist["loss"]
    assert losses[-1] < losses[0] * 0.7
    assert np.isfinite(losses).all()


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "examples",
                                                                     name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_example_runs_on_cpu():
    out = _run_example(["examples/quickstart_torch.py", "--device", "cpu", "--steps", "12",
                        "--race-steps", "2", "--trials", "20"])
    assert "PaME: f went 5.379 ->" in out
    assert "pame   loss    0.429 ->" in out and "dpsgd  loss    0.429 ->" in out
    assert "count-weighted" in out and "naive /t" in out


@pytest.mark.parametrize("partition", ["flat", "tree"])
def test_cnn_heterogeneity_example_runs_on_cpu(partition):
    out = _run_example(["examples/cnn_heterogeneity_torch.py", "--device", "cpu", "--steps",
                        "4", "--nodes", "4", "--classes", "3", "--partition", partition])
    lines = [ln for ln in out.splitlines() if "loss" in ln and "acc(mean model)" in ln]
    assert len(lines) == 2 and "PaME" in lines[0] and "D-PSGD" in lines[1]
    for ln in lines:
        first, last = (float(v) for v in ln.split("loss")[1].split(",")[0].split("->"))
        assert np.isfinite([first, last]).all()


@pytest.mark.parametrize("name,args", [
    ("quickstart_torch", ["--steps", "1"]),
    ("cnn_heterogeneity_torch", ["--steps", "1"]),
])
def test_examples_raise_without_a_card(name, args, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _example(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(args)


def test_quickstart_example_main_returns_its_numbers():
    """`main` returns what it prints (the chip smoke reads the parts)."""
    mod = _example("quickstart_torch")
    out = mod.main(["--device", "cpu", "--steps", "5", "--race-steps", "2", "--trials", "10"])
    ex1 = out["example1"]
    assert ex1["steps_run"] == len(ex1["objective"]) <= 5
    assert ex1["objective"][0] == pytest.approx(5.379, abs=5e-4)
    assert set(out["race"]) == {"pame", "dpsgd"}
    assert out["race"]["dpsgd"]["wire_bits_per_step"] == pytest.approx(160.0 * 8e3)
    th = out["theorem1"]
    assert th["target"].shape == th["count_weighted"].shape == th["naive"].shape == (8,)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_logreg_problem_matches_the_benchmarks():
    """Path F2's torch copy of Example 2 (`chip_smoke.logreg_problem`)
    against the benchmark's JAX `logreg_problem` (benchmarks/common.py):
    loss, gradient, objective and test accuracy at a random point."""
    from benchmarks.common import logreg_problem

    cs = _chip_smoke()
    m, n = 6, 40
    (ja, jy), jg, jobj, jacc = logreg_problem(m, n, spn=16, seed=3)
    (ta, ty), tg, tobj, tacc = cs.logreg_problem(torch.device("cpu"), m, n, spn=16, seed=3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    w = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    lj, gj = jg(jnp.asarray(w), (ja[2], jy[2]), None)
    lt, gt = tg(torch.as_tensor(w), (ta[2], ty[2]), None)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(tobj(torch.as_tensor(w))), float(jobj(jnp.asarray(w))),
                               rtol=RTOL)
    assert tacc(torch.as_tensor(w)) == jacc(jnp.asarray(w))


def test_chip_smoke_path_f_rehearsal(capsys):
    """`chip_smoke.py`'s path F (F1-F4) and parity phase F at tiny sizes on
    the CPU: every run's checks pass (objectives and losses fall, the F3
    accuracies reach 0.5), and each run reports its numbers; the parity
    phase's two routes coincide on the CPU (both plain), which rehearses
    its control flow."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    steps = dict(cs.F_STEPS, cnn=8, wide=16, resnet=8, profile=2)
    rows = cs.path_f1(cpu, steps=steps)
    assert rows["F1-pame"]["objective_last"] < 0.5 * rows["F1-pame"]["objective_first"]
    rows.update(cs.path_f2(cpu, m=8, n=50, steps=30))
    rows.update(cs.path_f3(cpu, spec=dict(cs.FMNIST, n=1600), steps=steps))
    rows.update(cs.path_f4(cpu, spec=dict(cs.CIFAR, n=1024), steps=steps))
    assert {f"F2-{a}" for a in TALG.list_algorithms()} <= {r["run"] for r in rows.values()}
    assert rows["F3-wide"]["params"] == 1_682_762
    assert rows["F4-pame"]["profile"]["wall_s_per_step"] > 0
    parity = cs.path_f_parity(cpu, sizes={"batch": 2, "forward": 4})
    assert set(parity) == {"cnn", "resnet20"}
    assert parity["resnet20"]["leaves"] == 61
    out = capsys.readouterr().out
    assert '"phase": "parity_f"' in out and '"run": "F4-pame"' in out
