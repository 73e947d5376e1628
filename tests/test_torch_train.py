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
    """No flag of the JAX trainer is left unported (the last one refused,
    --compile-cache, now parses like the rest); a flag the CLI lacks is
    refused by the parser."""
    from repro.launch import train as jtrain

    ours = ttrain.make_parser()._option_string_actions
    missing = [f for f in jtrain.make_parser()._option_string_actions if f not in ours]
    assert missing == []
    args = ttrain.make_parser().parse_args(["--arch", "x", "--compile-cache", "DIR"])
    assert args.compile_cache == "DIR"
    with pytest.raises(SystemExit):
        ttrain.make_parser().parse_args(["--arch", "x", "--no-such-flag"])


KAPPA2 = ["--kappa-lo", "2", "--kappa-hi", "2"]


@pytest.mark.parametrize("algo,flags", [
    ("pame", KAPPA2), ("dpsgd", ["--straggler", "0.3"]),
    ("pame", ["--edge-drop", "0.2", "--churn", "0.1"] + KAPPA2),
    ("pame", ["--straggler", "0.4", "--staleness", "2"] + KAPPA2),
    ("choco", ["--loss-rate", "0.2", "--crash", "0.05,0.5"])])
def test_cli_seeds_run_lanes_on_cpu(algo, flags, capsys):
    """--seeds 2 trains two seed lanes in one run (lane s from key seed + 1
    + s), logging the mean loss across lanes and its spread; on a static
    network lane 0's losses equal the single-seed run of its key.  Under
    the network flags (i.i.d. drops and churn, staleness, message loss and
    crashes with CHOCO's replicas) the lanes' realizations fold into one
    step, each lane drawing its network from its own key."""
    base = ["--arch", "stablelm-1.6b", "--variant", "smoke", "--nodes", "4", "--batch", "1",
            "--seq", "16", "--steps", "3", "--chunk", "2", "--device", "cpu", "--algo", algo]
    out = ttrain.main(base + flags + ["--seeds", "2"])
    log = capsys.readouterr().out
    assert "seeds=2 (batched lanes)" in log and "loss_std=" in log
    lanes = np.asarray(out["metrics"]["loss_mean"])
    assert lanes.shape == (3, 2) and np.isfinite(lanes).all()
    np.testing.assert_allclose(out["loss"], lanes.mean(axis=1), rtol=1e-6)
    if algo == "pame":
        # the exchange at step 2 (kappa = 2) draws from each lane's key
        assert lanes[-1, 0] != lanes[-1, 1]
    if flags == KAPPA2:
        # lane 0 starts from key seed + 1, the single-seed run's key
        single = ttrain.main(base + flags)
        np.testing.assert_array_equal(np.float32(single["loss"]), np.float32(lanes[:, 0]))


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
    assert int(res.stdout.strip()) >= 54


@pytest.mark.parametrize("example", ["quickstart_torch", "cnn_heterogeneity_torch",
                                     "train_dfl_lm_torch"])
def test_port_examples_import_neither_jax_nor_repro(example):
    """Loading a port example (its imports, not its main) pulls in neither
    the JAX package nor jax."""
    path = os.path.join(os.path.dirname(SRC), "examples", example + ".py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ex', {path!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_dfl_lm_example_reports_as_jax(capsys):
    """examples/train_dfl_lm_torch.py prints the JAX example's Eq.-(8)
    volume report line for line and trains through the port's CLI."""
    import importlib.util

    argv = ["--steps", "2", "--nodes", "2", "--batch", "1", "--seq", "16", "--p", "0.3"]
    path = os.path.join(os.path.dirname(SRC), "examples", "train_dfl_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_dfl_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(argv + ["--device", "cpu"])
    assert out["steps"] == 2 and np.isfinite(out["loss"]).all()
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[example]")]
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(os.path.dirname(SRC), "examples",
                                                       "train_dfl_lm.py"), *argv],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    want = [ln for ln in res.stdout.splitlines() if ln.startswith("[example]")]
    assert got == want and len(got) == 2


DYNAMIC_FLAGS = {
    "pame-harsh": ("pame", ["--scenario", "harsh"]),
    "dpsgd-temporal": ("dpsgd", ["--scenario", "flaky_links", "--burst", "0.1,0.5",
                                 "--session", "0.05,0.5", "--staleness", "2",
                                 "--straggler", "0.5"]),
    "pame-faults": ("pame", ["--loss-rate", "0.1", "--crash", "0.02,0.25",
                             "--msg-delay", "0.2,2"]),
    "choco-faults": ("choco", ["--loss-rate", "0.1", "--loss-burst", "0.05,0.3"]),
    "beer-no-repair": ("beer", ["--loss-rate", "0.3", "--no-repair", "--layers", "1"]),
    "anq_nids-mobile": ("anq_nids", ["--resample", "2", "--mobility-keep", "0.5",
                                     "--churn", "0.2"]),
}


@pytest.mark.parametrize("case", sorted(DYNAMIC_FLAGS))
def test_cli_dynamic_network_flags_run_on_cpu(case, capsys):
    """The scenario, temporal and fault flags of the JAX CLI on the smoke
    model: finite losses, the realized metrics in the log, and the
    staleness histogram when stragglers are mixed from the ring."""
    algo, flags = DYNAMIC_FLAGS[case]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = ttrain.main(["--arch", "stablelm-1.6b", "--variant", "smoke", "--nodes", "4",
                           "--batch", "1", "--seq", "8", "--steps", "3", "--chunk", "2",
                           "--device", "cpu", "--algo", algo] + flags)
    finally:
        torch.set_num_threads(n)
    assert out["steps"] == 3 and np.isfinite(out["loss"]).all()
    assert len(out["metrics"]["wire_bits"]) == 3 and len(out["metrics"]["alive_nodes"]) == 3
    log = capsys.readouterr().out
    assert "full graph — realized bits logged per step" in log and " alive=" in log
    if "--loss-rate" in flags:
        assert "+faults(" in log and " dropped=" in log and " drift=" in log
    if algo in ("choco", "beer") and "--loss-rate" in flags:
        assert " desync=" in log
    if "--staleness" in flags:
        assert "staleness histogram" in log and len(out["staleness_hist"]) == 3


def _log_rows(text):
    """{step: {field: value}} of the CLI's per-step log lines."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("[train] step="):
            fields = dict(f.split("=", 1) for f in line.split()[1:] if "=" in f)
            rows[int(fields.pop("step"))] = fields
    return rows


@pytest.mark.parametrize("algo,flags", [
    ("dpsgd", ["--scenario", "flaky_links", "--burst", "0.2,0.5", "--session", "0.2,0.5",
               "--staleness", "2", "--straggler", "0.4"]),
    ("choco", ["--scenario", "churn", "--loss-rate", "0.2", "--loss-burst", "0.1,0.3",
               "--crash", "0.1,0.5", "--msg-delay", "0.3,2"]),
])
def test_cli_realized_metrics_match_jax(algo, flags, capsys, monkeypatch):
    """The JAX CLI and the port's on the same flags, the port fed the JAX
    run's network draws (scenario, temporal, fault and stationary
    uniforms): the realized metrics of every step's log line agree — the
    alive, delayed and crashed counts, the dropped messages, the drift and
    the cumulative realized wire bits (the models' weights differ, the
    network's realizations do not)."""
    from repro.core import scenarios as jscen
    from repro.core.topology import build_topology as jtopo
    from repro.launch import train as jtrain
    from repro_torch.core import algorithms as talg

    from _torch_parity import (jax_fault_draws, jax_fault_init_draws, jax_scenario_draws,
                               jax_temporal_draws, jax_temporal_init_draws)

    argv = ["--arch", "stablelm-1.6b", "--variant", "smoke", "--nodes", "4", "--batch", "1",
            "--seq", "8", "--steps", "4", "--chunk", "1", "--algo", algo] + flags
    jargs = jtrain.make_parser().parse_args(argv)
    jscenario = jtrain._scenario_from_args(jargs)
    jfaults = jtrain._faults_from_args(jargs)
    if jfaults is not None and jscenario.is_static:
        jscenario = jscen.Scenario(name="static")
    arrays = jscen.make_scenario_arrays(jtopo("erdos_renyi", 4, p=0.5, seed=0), jscenario)
    fkey = None if jfaults is None else jax.random.PRNGKey(jfaults.seed)
    d = arrays.nbrs.shape[1]
    step0, aux0 = talg.BoundAlgorithm.step, talg.BoundAlgorithm.aux_init

    def step(self, state, batch, k=None, aux=None, *, draws=None):
        if fkey is not None:
            draws = {"scenario": jax_scenario_draws(arrays, k),
                     "faults": jax_fault_draws(fkey, k, 4, d)}
        elif self.temporal:
            draws = {"temporal": jax_temporal_draws(jscenario, arrays, k)}
        else:
            draws = {"scenario": jax_scenario_draws(arrays, k)}
        return step0(self, state, batch, k, aux, draws=draws)

    def aux_init(self, state, *, u=None):
        u = (jax_fault_init_draws(fkey, 4, d) if fkey is not None
             else jax_temporal_init_draws(arrays))
        return aux0(self, state, u=u)

    monkeypatch.setattr(talg.BoundAlgorithm, "step", step)
    monkeypatch.setattr(talg.BoundAlgorithm, "aux_init", aux_init)
    jtrain.main(argv)
    want = _log_rows(capsys.readouterr().out)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ttrain.main(argv + ["--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    got = _log_rows(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4]
    fields = {"alive", "stale", "crashed", "dropped", "drift", "wire_gbits"}
    for k in want:
        assert fields & set(want[k]) == fields & set(got[k]) != set(), k
        for f in fields & set(want[k]):
            assert float(got[k][f]) == pytest.approx(float(want[k][f]), rel=1e-4, abs=1e-3), (k, f)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "internvl2-2b"])
def test_new_arch_pame_steps_match_jax(arch):
    """test_lm_pame_steps_match_jax's slice on an MLA + MoE model (its loss
    carries the MoE aux terms) and on the vlm stand-in (random patch
    embeddings before the text): three PaME steps of the trainer's sparse
    exchange with JAX's draws injected, losses at rtol 1e-5 and parameters
    at atol 1e-4."""
    cfg_j, cfg_t = jget_config(arch, "smoke"), get_config(arch, "smoke")
    pcfg = jpame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, mask_mode="bernoulli",
                            mixing="sparse")
    pcfg_t = tpame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, mask_mode="bernoulli",
                              mixing="sparse")
    ta_j = jpame.make_topology_arrays(jbuild("erdos_renyi", M, p=0.5, seed=0), pcfg, seed=0)
    ta_t = tpame.make_topology_arrays(tbuild("erdos_renyi", M, p=0.5, seed=0), pcfg_t,
                                      seed=0, device="cpu")
    stacked = jax.vmap(lambda k: jinit(k, cfg_j))(jax.random.split(jax.random.PRNGKey(0), M))
    key = jax.random.PRNGKey(1)
    sj = jpame.pame_init(key, stacked, M, pcfg)
    st = tpame.pame_init(1, convert.to_torch(jax.device_get(stacked)), M, pcfg_t)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_j.vocab, (3, M, 2, 12)).astype(np.int32)
    patches = (rng.standard_normal((3, M, 2, cfg_j.n_patches, cfg_j.vision_dim))
               .astype(np.float32) if cfg_j.arch_type == "vlm" else None)

    def batch(k, fn):
        b = {"tokens": fn(toks[k])}
        if patches is not None:
            b["patch_embeds"] = fn(patches[k])
        return b

    def j_grad(p, b, k):
        return jax.value_and_grad(lambda pp: jloss(pp, cfg_j, b))(p)

    step_j = jax.jit(lambda s, b: jpame.pame_step(s, b, j_grad, ta_j, pcfg))
    for k in range(3):
        draws = jax_step_draws(key, k, sj.params, ta_j, pcfg)
        sj, mj = step_j(sj, batch(k, jnp.asarray))
        st, mt = tpame.pame_step(st, batch(k, torch.as_tensor), _t_grad(cfg_t), ta_t, pcfg_t,
                                 draws=draws)
        np.testing.assert_allclose(float(mt["loss_mean"]), float(mj["loss_mean"]), rtol=1e-5)
        for g, w in zip(convert.flatten(st.params), jax.tree_util.tree_leaves(sj.params)):
            np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("arch,seq", [("deepseek-v2-lite-16b", "12"), ("internvl2-2b", "20")])
def test_cli_runs_new_archs_on_cpu(arch, seq, capsys):
    """The CLI on the MLA + MoE smoke model and on the vlm smoke model (its
    batches carry zero patch embeddings): finite losses, one line a step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = ttrain.main(["--arch", arch, "--variant", "smoke", "--nodes", "4", "--batch", "1",
                           "--seq", seq, "--steps", "3", "--chunk", "1", "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert out["steps"] == 3 and np.isfinite(out["loss"]).all()
    assert "[train] step=3 loss=" in capsys.readouterr().out
    cfg = get_config(arch, "smoke")
    batch = ttrain.lm_batch_fn(cfg, 4, 1, int(seq), 0, torch.device("cpu"))(0)
    want = {"tokens": (4, 1, int(seq))}
    if cfg.arch_type == "vlm":
        want["patch_embeds"] = (4, 1, cfg.n_patches, cfg.vision_dim)
        assert not batch["patch_embeds"].any()
    assert {k: tuple(v.shape) for k, v in batch.items()} == want
    with pytest.raises(ValueError, match="n_patches"):  # the JAX CLI's seq check
        ttrain.main(["--arch", "internvl2-2b", "--variant", "smoke", "--seq", "16",
                     "--device", "cpu"])


def test_chip_smoke_path_i_rehearsal(capsys):
    """`chip_smoke.py`'s path I at tiny sizes on the CPU: I1 through the
    trainer CLI on deepseek-lite-smoke at 3 layers and its three remat
    runs (equal losses), I2's MLA + MoE serving with chunked prefill, I3's
    flash-flag serving (the plain route on the CPU), I4's five configs and
    qwen3's chunked GQA prefill against the unchunked one, and I5's
    optimizers: every check of each phase passes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(SRC), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cpu = torch.device("cpu")
    small = dict(prompt_len=8, gen=3, batch=2, seed=0)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        i1, launches = cs.path_i1(cpu, variant="smoke", batch=1, seq=16, remat_batch=1,
                                  remat_seq=16)
        i2 = cs.path_i2(cpu, cfg=get_config(cs.I_LM, "smoke").replace(prefill_chunk=4), serve=small)
        i3, _ = cs.path_i3(cpu, cfg=get_config("qwen3-14b", "smoke").replace(use_flash=True),
                           serve=small)
        i4 = cs.path_i4(cpu, variant="smoke", serve=small,
                        chunk=dict(prompt_len=8, chunk=4, atol=1e-5))
        i5 = cs.path_i5(cpu)
    finally:
        torch.set_num_threads(n)
    assert launches == 0 and i1["leaves"] == 28 and len(i1["loss"]) == cs.I_STEPS
    assert sorted(i1["remat"]) == ["dots", "full", "none"]
    assert len({r["loss"] for r in i1["remat"].values()}) == 1
    assert i1["remat"]["full"]["grads_equal"] and i1["remat"]["dots"]["grads_equal"]
    assert i2["token_shape"] == i3["token_shape"] == [2, 3]
    assert i4["internvl2-2b"]["offset"] == get_config("internvl2-2b", "smoke").n_patches
    assert sorted(i4) == sorted(cs.I4_ARCHS + ("qwen3-14b chunked",))
    assert all(r["last"] < r["first"] for r in i5.values())
    out = capsys.readouterr().out
    assert '"phase": "path_i1_remat"' in out and '"phase": "path_i5"' in out
