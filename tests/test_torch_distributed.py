"""The port's sharded PaME step on 8 gloo ranks against JAX's sharded step.

JAX's side runs as `tests/test_distributed_equivalence.py` runs it: a
subprocess with 8 fake XLA host devices on a 4 × 1 × 2 (node, fsdp, model)
mesh, `pame_step(..., param_shardings=state_sh.params)`.  The port's side
is one world of 8 gloo processes on 127.0.0.1 over the same placements
(`repro_torch.sharding.state_shardings`, `launch.mesh.make_logical_mesh`),
each rank holding its pieces, with JAX's draws injected.  Smoke
stablelm-1.6b, m = 4, and node rows that differ: params0 plus 0.01 · N(0, 1)
numpy noise (seed 1), so that an exchange blocked along other coordinates
shows.  JAX's sharded compressed step is not its unsharded step on leaves
whose axis 1 is placed (the embedding here: ROADMAP, queue 3), so the
port is held to JAX's sharded step.  Every leaf and ``loss_mean`` within
1e-5 of it (the JAX test's tolerance); the dense and sparse exchanges also
bit-equal to the port's unsharded step, and so are the dense and sparse
exchanges with exact masks drawn by the step itself (every rank draws the
whole leaves' masks and keeps its piece; the unsharded exact steps are
held to JAX in tests/test_torch_pame.py).  One JAX subprocess and one
world serve every case, and run beside each other; each case is its own
test.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import jax_step_draws, to_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, RANKS, LAYOUT = 4, 8, {"node": 4, "fsdp": 1, "model": 2}
TOL = 1e-5
# (exchange, mixing, mask mode) of each case; the JAX test's hyperparameters.
# JAX_CASES run on both sides with JAX's draws; the exact ones on the port's
# side alone, with the step's own draws
JAX_CASES = {
    "dense": ("dense", "dense", "bernoulli"),
    "sparse": ("dense", "sparse", "bernoulli"),
    "compressed": ("compressed", "dense", "bernoulli"),
    "compressed_q8": ("compressed_q8", "dense", "bernoulli"),
}
CASES = dict(JAX_CASES, **{"dense-exact": ("dense", "dense", "exact"),
                           "sparse-exact": ("dense", "sparse", "exact")})
BIT_EQUAL = ("dense", "sparse", "dense-exact", "sparse-exact")
HP = dict(nu=0.5, p=0.25, gamma=1.01, sigma0=20.0, homogeneous_kappa=2)

JAX_CODE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.launch.mesh import mesh_axis_kwargs
    from repro.configs import get_config
    from repro.core.pame import PaMEConfig, pame_init, pame_step, make_topology_arrays
    from repro.core.topology import build_topology
    from repro.models.model import init_params, train_loss
    from repro import sharding as shd

    work, cases = sys.argv[1], sys.argv[2:]
    data = np.load(os.path.join(work, "inputs.npz"))
    cfg = get_config("stablelm-1.6b", "smoke")
    td = jax.tree_util.tree_structure(init_params(jax.random.PRNGKey(0), cfg))
    n = td.num_leaves
    stacked = jax.tree_util.tree_unflatten(td, [jnp.asarray(data[f"p{i}"]) for i in range(n)])
    batch = {"tokens": jnp.asarray(data["tokens"])}
    devs = np.array(jax.devices()[:8]).reshape(4, 1, 2)
    mesh = Mesh(devs, ("node", "fsdp", "model"), **mesh_axis_kwargs(3))

    def grad_fn(p, b, k):
        return jax.value_and_grad(lambda pp: train_loss(pp, cfg, b))(p)

    out = {}
    for case in cases:
        exchange, mixing, mode = case.split(":")
        pcfg = PaMEConfig(nu=0.5, p=0.25, gamma=1.01, sigma0=20.0, homogeneous_kappa=2,
                          mask_mode=mode, exchange=exchange, mixing=mixing)
        arrs = make_topology_arrays(build_topology("ring", 4), pcfg)
        state = pame_init(jax.random.PRNGKey(1), stacked, 4, pcfg)
        specs = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state)
        state_sh = shd.state_shardings(specs, mesh)
        batch_sh = shd.batch_shardings(
            {"tokens": jax.ShapeDtypeStruct(batch["tokens"].shape, jnp.int32)}, mesh, True)
        with mesh:
            fn = jax.jit(lambda s, b: pame_step(s, b, grad_fn, arrs, pcfg,
                                                param_shardings=state_sh.params),
                         in_shardings=(state_sh, batch_sh))
            new, met = fn(jax.device_put(state, state_sh), jax.device_put(batch, batch_sh))
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
            out[f"{case}|{i}"] = np.asarray(leaf)
        out[f"{case}|loss"] = np.asarray(met["loss_mean"])
    np.savez(os.path.join(work, "jax.npz"), **out)
    print("JAX OK")
""")

RANK_CODE = textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    work, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=8)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.core import pame as tp
    from repro_torch.core.topology import build_topology
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models.model import train_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    cfg = get_config("stablelm-1.6b", "smoke")
    layout = {"node": 4, "fsdp": 1, "model": 2}
    mesh = make_logical_mesh(device_type="cpu", layout=layout)
    coord = shd.mesh_coords(mesh)

    def grad_fn(p, b, k):
        leaves, td = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    def objective(mean_params):  # the test module's _objective
        return sum(torch.sum(x.float() ** 2) for x in tree_flatten(mean_params)[0])

    out = {}
    for case, (exchange, mixing, mode) in inputs["cases"].items():
        pcfg = tp.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **inputs["hp"])
        arrs = tp.make_topology_arrays(build_topology("ring", 4), pcfg, device="cpu")
        state = tp.pame_init(1, inputs["stacked"], 4, pcfg)
        place = shd.state_shardings(state, layout)
        sharded = shd.MeshShardings(mesh, place.params)
        local = shd.shard_tree(state, place, layout, coord)
        batch = shd.shard_tree(inputs["batch"], {"tokens": ("node", None, None)}, layout, coord)
        new, met = tp.pame_step(local, batch, grad_fn, arrs, pcfg, param_shardings=sharded,
                                draws=inputs["draws"].get(case))
        whole = shd.gather_tree(new.params, sharded)
        out[case] = {"params": whole, "loss_mean": met["loss_mean"],
                     "consensus": met["consensus"], "sigma_mean": met["sigma_mean"]}
    out["collectives"] = shd.collective_counts()
    # the sharded runner: 3 steps in chunks of 2 under the stop rule's
    # objective, from one single-node params0
    pcfg = tp.PaMEConfig(mask_mode="exact", **inputs["hp"])
    layout_sh = shd.state_shardings(tp.pame_init(1, inputs["stacked"], 4, pcfg), layout)
    sharded = shd.MeshShardings(mesh, layout_sh.params)
    run = tp.make_pame_runner(grad_fn, build_topology("ring", 4), pcfg,
                              objective_fn=objective, tol_std=0.0, chunk_size=2,
                              device="cpu", param_shardings=sharded)
    state, hist = run(1, inputs["params0"], 4, lambda k: inputs["batch"], 3)
    out["runner"] = {"params": shd.gather_tree(state.params, sharded), "history": hist}
    if rank == 0:
        torch.save(out, os.path.join(work, "port.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _objective(mean_params):
    """The stop rule's objective in the runner case (the ranks define the
    same): a function of every leaf of the node-mean parameters."""
    from repro_torch.tree import tree_leaves

    return sum(torch.sum(x.float() ** 2) for x in tree_leaves(mean_params))


def _port_runner(params0, batch):
    """The port's unsharded runner as the ranks run the sharded one."""
    from repro_torch.configs import get_config
    from repro_torch.core import pame as tp
    from repro_torch.core.topology import build_topology
    from repro_torch.models.model import train_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg = get_config("stablelm-1.6b", "smoke")

    def grad_fn(p, b, k):
        leaves, td = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    run = tp.make_pame_runner(grad_fn, build_topology("ring", M),
                              tp.PaMEConfig(mask_mode="exact", **HP), objective_fn=_objective,
                              tol_std=0.0, chunk_size=2, device="cpu")
    state, hist = run(1, params0, M, lambda k: batch, 3)
    return state.params, hist


def _port_step(stacked, batch, draws, exchange, mixing, mode):
    """The port's unsharded step on the same inputs and draws."""
    from repro_torch.configs import get_config
    from repro_torch.core import pame as tp
    from repro_torch.core.topology import build_topology
    from repro_torch.models.model import train_loss
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

    cfg = get_config("stablelm-1.6b", "smoke")

    def grad_fn(p, b, k):
        leaves, td = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    pcfg = tp.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **HP)
    arrs = tp.make_topology_arrays(build_topology("ring", M), pcfg, device="cpu")
    state = tp.pame_init(1, tree_map(torch.clone, stacked), M, pcfg)
    new, met = tp.pame_step(state, batch, grad_fn, arrs, pcfg, draws=draws)
    return new.params, met


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps (subprocess), the port's sharded steps (8 gloo
    ranks) and the port's unsharded dense and sparse steps, all cases."""
    from repro.configs import get_config as jget_config
    from repro.core import pame as jpame
    from repro.core.topology import build_topology as jbuild
    from repro.models.model import init_params as jinit
    from repro_torch import convert
    from repro_torch.tree import tree_map

    work = str(tmp_path_factory.mktemp("distributed"))
    cfg = jget_config("stablelm-1.6b", "smoke")
    stacked = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (M,) + x.shape),
                                     jinit(jax.random.PRNGKey(0), cfg))
    leaves, td = jax.tree_util.tree_flatten(stacked)
    rng = np.random.default_rng(1)
    leaves = [np.asarray(x) + (0.01 * rng.standard_normal(x.shape)).astype(x.dtype)
              for x in leaves]
    stacked = jax.tree_util.tree_unflatten(td, [jnp.asarray(x) for x in leaves])
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (M, 2, 32)).astype(np.int32)
    np.savez(os.path.join(work, "inputs.npz"), tokens=tokens,
             **{f"p{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, work, *(":".join(c) for c in JAX_CASES.values())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    draws = {}
    for case, (exchange, mixing, mode) in JAX_CASES.items():
        jcfg = jpame.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **HP)
        arrs = jpame.make_topology_arrays(jbuild("ring", M), jcfg)
        draws[case] = jax_step_draws(jax.random.PRNGKey(1), 0, stacked, arrs, jcfg)
    t_stacked = convert.to_torch(jax.device_get(stacked))
    t_batch = {"tokens": torch.as_tensor(tokens)}
    params0 = tree_map(lambda x: x[0].clone(), t_stacked)
    torch.save({"stacked": t_stacked, "batch": t_batch, "draws": draws, "cases": CASES,
                "hp": HP, "params0": params0},
               os.path.join(work, "inputs.pt"))
    port = str(_free_port())
    ranks = [subprocess.Popen([sys.executable, "-c", RANK_CODE, work, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(RANKS)]
    # one torch thread, as in the ranks: the CPU's multithreaded embedding
    # backward sums in no fixed order, so two runs of one step could differ
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        unsharded = {case: _port_step(t_stacked, t_batch, draws.get(case), *CASES[case])
                     for case in BIT_EQUAL + ("compressed",)}
        unsharded["runner"] = _port_runner(params0, t_batch)
    finally:
        torch.set_num_threads(threads)
    logs = []
    try:
        for proc in [jax_proc] + ranks:
            logs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in [jax_proc] + ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip([jax_proc] + ranks, logs):
        assert proc.returncode == 0, log[-3000:]
    jax_out = dict(np.load(os.path.join(work, "jax.npz")))
    port_out = torch.load(os.path.join(work, "port.pt"))
    jax_res = {}
    for case in JAX_CASES:
        key = ":".join(CASES[case])
        jax_res[case] = ([jax_out[f"{key}|{j}"] for j in range(len(leaves))],
                         float(jax_out[f"{key}|loss"]))
    return jax_res, port_out, unsharded


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_step_matches_jax_sharded(runs, case):
    """Every leaf and loss_mean within 1e-5 of JAX's sharded step on the
    4 × 1 × 2 mesh, with distinct node rows."""
    from repro_torch.tree import tree_leaves

    jax_res, port_out, _ = runs
    want_leaves, want_loss = jax_res[case]
    got = port_out[case]
    got_leaves = tree_leaves(got["params"])
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_np(g), w, rtol=0, atol=TOL)
    assert abs(float(got["loss_mean"]) - want_loss) < TOL


@pytest.mark.parametrize("case", BIT_EQUAL)
def test_sharded_step_bit_equal_to_unsharded(runs, case):
    """The dense and sparse exchanges sharded give the port's unsharded
    step bit for bit: the state and loss_mean (Bernoulli masks injected
    from JAX, exact masks drawn by the step from its key on every rank)."""
    from repro_torch.tree import tree_leaves

    _, port_out, unsharded = runs
    want_params, want_met = unsharded[case]
    got = port_out[case]
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(want_params)):
        assert torch.equal(g, w)
    assert torch.equal(got["loss_mean"], want_met["loss_mean"])
    assert torch.equal(got["sigma_mean"], want_met["sigma_mean"])
    torch.testing.assert_close(got["consensus"], want_met["consensus"], rtol=1e-6, atol=0)


def test_sharded_runner_matches_unsharded_runner(runs):
    """`make_pame_runner(param_shardings=)` on the 8 ranks, 3 steps in
    chunks of 2 from one params0 with the stop rule's objective taken on
    the node mean gathered whole: the final state and the losses equal the
    unsharded runner's bit for bit, the objectives to f32 rounding."""
    from repro_torch.tree import tree_leaves

    _, port_out, unsharded = runs
    want_params, want_hist = unsharded["runner"]
    got = port_out["runner"]
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(want_params)):
        assert torch.equal(g, w)
    assert got["history"]["loss"] == want_hist["loss"]
    assert got["history"]["steps_run"] == want_hist["steps_run"] == 3
    np.testing.assert_allclose(got["history"]["objective"], want_hist["objective"], rtol=1e-6)


def test_compressed_sharded_differs_from_unsharded_on_placed_axis_1(runs):
    """Reference-side finding (ROADMAP, queue 3): with distinct node rows,
    the sharded compressed exchange blocks the embedding, whose axis 1
    (vocab) is placed over `model`, along d, and the unsharded one along
    vocab, so the two steps' embeddings differ well beyond the tolerance
    (JAX's sharded one, which the port matches above, and the port's
    unsharded one, which matches JAX's unsharded step in
    tests/test_torch_pame.py's setting)."""
    from repro_torch.tree import tree_leaves

    _, port_out, unsharded = runs
    sharded = to_np(tree_leaves(port_out["compressed"]["params"])[0])  # embed, JAX order
    plain = to_np(tree_leaves(unsharded["compressed"][0])[0])
    assert sharded.shape == plain.shape == (M, 512, 256)
    assert np.abs(sharded - plain).max() > 1e3 * TOL


def test_collectives_counted_by_kind(runs):
    """The sharded steps issued all-gathers (the exchange over node, the
    gradient's gather over model) and all-reduces (the metrics, q8's
    scale), and the wrapper counted the bytes each rank received."""
    _, port_out, _ = runs
    counts = port_out["collectives"]
    assert set(counts) == {"all_gather", "all_reduce"}
    assert all(c["calls"] > 0 and c["bytes"] > 0 for c in counts.values())


def test_chip_smoke_path_k_rehearsal():
    """Path K of chip_smoke.py on the CPU at the smoke config: one gloo rank,
    a (1, 1, 1) mesh, each exchange's sharded step bit-equal to the
    unsharded one (no kernel launched on the CPU); and J1-dry, the dry
    run's own train step on real tensors."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    launches = cs.path_k(torch.device("cpu"), variant="smoke")
    assert launches == {"pme_average": 0, "pme_average_range": 0, "f32": 0}
    row = cs.path_j1_dry(torch.device("cpu"), batch=1, seq=16, variant="smoke")
    assert np.isfinite(row["loss"]) and row["peak_bytes"] is None
