"""The slice as a whole: PaME training of the stablelm SMOKE model against
the JAX package with injected draws (sparse exchange with Bernoulli masks,
as the trainer runs it, and the dense exact exchange of `PaMEConfig`'s
defaults), to atol 1e-4 over three steps; the CLI on the CPU; the port's
import isolation; and entry points that refuse to run without a card."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core import pame as jpame
from repro.core.topology import build_topology as jbuild
from repro.models.model import init_params as jinit, train_loss as jloss
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import pame as tpame
from repro_torch.core.topology import build_topology as tbuild
from repro_torch.launch import train as ttrain
from repro_torch.models.model import train_loss
from repro_torch.tree import tree_flatten, tree_unflatten

from _torch_parity import jax_step_draws, to_np

M = 4
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _t_grad(cfg):
    def grad_fn(p, b, key):
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
    return grad_fn


@pytest.mark.parametrize("mixing,mode", [("sparse", "bernoulli"), ("dense", "exact")])
def test_lm_pame_steps_match_jax(mixing, mode):
    cfg_j = jget_config("stablelm-1.6b", "smoke")
    cfg_t = get_config("stablelm-1.6b", "smoke")
    pcfg = jpame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0,
                            mask_mode=mode, mixing=mixing)
    pcfg_t = tpame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0,
                              mask_mode=mode, mixing=mixing)
    topo_j = jbuild("erdos_renyi", M, p=0.5, seed=0)
    ta_j = jpame.make_topology_arrays(topo_j, pcfg, seed=0)
    ta_t = tpame.make_topology_arrays(tbuild("erdos_renyi", M, p=0.5, seed=0), pcfg_t,
                                      seed=0, device="cpu")
    # distinct node models, so the exchange moves real values
    stacked = jax.vmap(lambda k: jinit(k, cfg_j))(jax.random.split(jax.random.PRNGKey(0), M))
    key = jax.random.PRNGKey(1)
    sj = jpame.pame_init(key, stacked, M, pcfg)
    st = tpame.pame_init(1, convert.to_torch(jax.device_get(stacked)), M, pcfg_t)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (3, M, 2, 16)).astype(np.int32)

    def j_grad(p, b, k):
        return jax.value_and_grad(lambda pp: jloss(pp, cfg_j, b))(p)

    step_j = jax.jit(lambda s, b: jpame.pame_step(s, b, j_grad, ta_j, pcfg))
    for k in range(3):
        draws = jax_step_draws(key, k, sj.params, ta_j, pcfg)
        sj, mj = step_j(sj, {"tokens": jnp.asarray(toks[k])})
        st, mt = tpame.pame_step(st, {"tokens": torch.as_tensor(toks[k])}, _t_grad(cfg_t),
                                 ta_t, pcfg_t, draws=draws)
        np.testing.assert_allclose(float(mt["loss_mean"]), float(mj["loss_mean"]), rtol=1e-5)
        for g, w in zip(convert.flatten(st.params), jax.tree_util.tree_leaves(sj.params)):
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4)


def test_cli_runs_on_cpu(capsys):
    out = ttrain.main(["--arch", "stablelm-1.6b", "--variant", "smoke", "--nodes", "4",
                       "--batch", "2", "--seq", "16", "--steps", "3", "--chunk", "2",
                       "--device", "cpu"])
    assert out["steps"] == 3 and len(out["loss"]) == 3
    assert np.isfinite(out["loss"]).all()
    log = capsys.readouterr().out
    assert "[train] step=2 loss=" in log and "[train] step=3 loss=" in log
    assert "[train] done" in log


@pytest.mark.parametrize("algo", ["dpsgd", "dfedsam", "choco", "beer", "anq_nids"])
def test_cli_runs_each_baseline_on_cpu(algo, capsys):
    """--algo for every baseline, with --lr / --rho reaching its hps.  Torch
    runs on one intra-op thread here: the smoke model's ops are tiny, and
    beside other test workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = ttrain.main(["--arch", "stablelm-1.6b", "--variant", "smoke", "--nodes", "4",
                           "--batch", "1", "--seq", "8", "--steps", "2", "--chunk", "1",
                           "--lr", "0.02", "--rho", "0.02", "--device", "cpu", "--algo", algo])
    finally:
        torch.set_num_threads(n)
    assert out["steps"] == 2 and len(out["loss"]) == 2
    assert np.isfinite(out["loss"]).all()
    log = capsys.readouterr().out
    assert f"[train] algo={algo} mixing=sparse" in log and "[train] step=2 loss=" in log
    assert "consensus=" not in log  # PaME's metrics only
    args = ttrain.make_parser().parse_args(["--arch", "x", "--algo", algo, "--lr", "0.02",
                                            "--rho", "0.03"])
    hps = ttrain._hps_from_args(algo, args)
    assert hps.lr == 0.02 and getattr(hps, "rho", 0.03) == 0.03


def test_cli_unported_flags_raise():
    base = ["--arch", "stablelm-1.6b", "--device", "cpu"]
    for extra in (["--scenario", "churn"], ["--seeds", "2"], ["--loss-rate", "0.1"],
                  ["--ckpt-dir", "x"]):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ttrain.main(base + extra)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "stablelm-1.6b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpame.run_pame(0, torch.zeros(3), 4, None, None, tbuild("ring", 4),
                       tpame.PaMEConfig(), num_steps=1)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 25
