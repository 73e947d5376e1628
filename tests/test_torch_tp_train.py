"""The port's tensor-parallel PaME step on 8 gloo ranks against JAX's sharded
step on 8 fake XLA host devices.

JAX's side is one subprocess with ``--xla_force_host_platform_device_count=8``
that jits `repro.core.pame.pame_step(..., param_shardings=)` with the state
placed by `repro.sharding.state_shardings` and the batch's tokens [m, b, s]
by `batch_shardings(..., node_stacked=True)`, (node, fsdp, None), as
`tests/test_distributed_equivalence.py` runs it: XLA partitions each node's
forward and backward over fsdp and model.  The port's side is one world of 8
gloo processes on 127.0.0.1: each rank holds its pieces of the state and
its piece of the batch (`core.pame.shard_batch`: its nodes, and each
node's rows over fsdp) and steps `pame_step` with `launch.train.lm_grad_fn`,
which takes a view: every node's loss and gradient run on the rank's pieces,
tensor-parallel over `model`, each layer gathered over fsdp just before it
runs.  JAX's draws are injected (Bernoulli masks).  Weights are JAX's
`init_params(PRNGKey(0))` stacked over m = 4 nodes plus 0.01 · N(0, 1)
numpy noise (seed 1), carried across with `repro_torch.convert`; tokens
come from one numpy seed.  Smoke configs in f32: stablelm (and with
remat), qwen3 (5 heads on 1 KV head: its wq / wk / wv gathered over `model`
at t = 4), zamba2 (the hybrid, its fused Mamba projection gathered, its
shared block), mamba2 (fused, and with the split projections), and
deepseek-v2-lite (MLA and expert-parallel MoE, and at a capacity factor of
1.0, where experts overflow), each with the dense and the sparse exchange
at (node, fsdp, model) = (1, 2, 4) and (2, 2, 2); stablelm also at (4, 1, 2)
with all four exchanges.

Held: every leaf of the new state and ``loss_mean`` within 1e-5 of JAX's,
every node's gradient, assembled from the ranks' pieces, within 1e-5 of the
port's unsharded step's leaf by leaf; the collectives (the gradient
reduce-scattered, never gathered whole).  A ninth process, one gloo rank on
a (1, 1, 1) mesh, holds the one-rank view bit for bit to the unsharded step
for every model.  One JAX subprocess and one world serve every case, beside
each other; each case is its own test.
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
M, B, S = 4, 2, 16
TOL = 1e-5
# a model "arch+mod" is the arch's smoke config with MODS[mod] replaced
MODELS = ("stablelm-1.6b", "stablelm-1.6b+remat", "qwen3-14b", "zamba2-1.2b", "mamba2-1.3b",
          "mamba2-1.3b+split", "deepseek-v2-lite-16b", "deepseek-v2-lite-16b+drop")
MODS = {"split": {"ssm_split_proj": True}, "remat": {"remat": True},
        # 4 experts, top-2: a buffer holds T / 2 of a node's T tokens
        "drop": {"capacity_factor": 1.0}}
LAYOUTS = {"1x2x4": (1, 2, 4), "2x2x2": (2, 2, 2), "4x1x2": (4, 1, 2)}
# (exchange, mixing) of each exchange; the JAX test's hyperparameters
EXCHANGES = {"dense": ("dense", "dense"), "sparse": ("dense", "sparse"),
             "compressed": ("compressed", "dense"), "compressed_q8": ("compressed_q8", "dense")}
HP = dict(nu=0.5, p=0.25, gamma=1.01, sigma0=20.0, homogeneous_kappa=2, mask_mode="bernoulli")
CASES = ([f"{model}@{layout}@{ex}" for model in MODELS for layout in ("1x2x4", "2x2x2")
          for ex in ("dense", "sparse")]
         + [f"stablelm-1.6b@4x1x2@{ex}" for ex in EXCHANGES])
# JAX's side compiles a step a case (about 5 s each on one CPU core): the
# cases are split over this many subprocesses
JAX_PROCS = 4

JAX_CODE = f"MODS = {MODS!r}\nEXCHANGES = {EXCHANGES!r}\nHP = {HP!r}\n" + textwrap.dedent("""
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

    work, part, cases = sys.argv[1], sys.argv[2], sys.argv[3:]
    data = np.load(os.path.join(work, "inputs.npz"))
    sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
    out = {}
    for case in cases:
        model, layout, ex = case.split("@")
        arch, _, mod = model.partition("+")
        cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
        td = jax.tree_util.tree_structure(init_params(jax.random.PRNGKey(0), cfg))
        stacked = jax.tree_util.tree_unflatten(
            td, [jnp.asarray(data[f"{model}|p{i}"]) for i in range(td.num_leaves)])
        batch = {"tokens": jnp.asarray(data["tokens"])}
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(tuple(map(int, layout.split("x")))),
                    ("node", "fsdp", "model"), **mesh_axis_kwargs(3))

        def grad_fn(p, b, k, cfg=cfg):
            return jax.value_and_grad(lambda pp: train_loss(pp, cfg, b))(p)

        exchange, mixing = EXCHANGES[ex]
        pcfg = PaMEConfig(exchange=exchange, mixing=mixing, **HP)
        arrs = make_topology_arrays(build_topology("ring", 4), pcfg)
        state = pame_init(jax.random.PRNGKey(1), stacked, 4, pcfg)
        state_sh = shd.state_shardings(jax.tree_util.tree_map(sds, state), mesh)
        batch_sh = shd.batch_shardings(jax.tree_util.tree_map(sds, batch), mesh, True)
        with mesh:
            fn = jax.jit(lambda s, b: pame_step(s, b, grad_fn, arrs, pcfg,
                                                param_shardings=state_sh.params),
                         in_shardings=(state_sh, batch_sh))
            new, met = fn(jax.device_put(state, state_sh), jax.device_put(batch, batch_sh))
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
            out[f"{case}|{i}"] = np.asarray(leaf)
        out[f"{case}|loss"] = np.asarray(met["loss_mean"])
    np.savez(os.path.join(work, f"jax{part}.npz"), **out)
    print("JAX OK")
""")

# the port's step on one rank (`rank` of `world`), every case of `cases`;
# with world 1, the (1, 1, 1) view against the unsharded step
RANK_CODE = f"MODS = {MODS!r}\nEXCHANGES = {EXCHANGES!r}\n" + textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    work, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    cases = sys.argv[5:]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.core import pame as tp
    from repro_torch.core.topology import build_topology
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.launch.train import lm_grad_fn
    from repro_torch.tree import tree_leaves, tree_map

    inputs = torch.load(os.path.join(work, "inputs.pt"))

    def recording(cfg, grads):
        inner = lm_grad_fn(cfg)

        def grad_fn(p, b, k, view=None):
            loss, g = inner(p, b, k, view=view)
            grads.append([x.clone() for x in tree_leaves(g)])
            return loss, g
        return grad_fn

    def step(case, sizes):
        model, _, ex = case.split("@")
        arch, _, mod = model.partition("+")
        cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
        exchange, mixing = EXCHANGES[ex]
        pcfg = tp.PaMEConfig(exchange=exchange, mixing=mixing, **inputs["hp"])
        arrs = tp.make_topology_arrays(build_topology("ring", 4), pcfg, device="cpu")
        state = tp.pame_init(1, tree_map(torch.clone, inputs["stacked"][model]), 4, pcfg)
        grads = []
        grad_fn = recording(cfg, grads)
        draws = inputs["draws"][f"{model}@{ex}"]
        if sizes is None:
            new, met = tp.pame_step(state, inputs["batch"], grad_fn, arrs, pcfg, draws=draws)
            return new.params, met, grads
        mesh = make_logical_mesh(device_type="cpu", layout=sizes)
        coord = shd.mesh_coords(mesh)
        place = shd.state_shardings(state, sizes)
        sharded = shd.MeshShardings(mesh, place.params)
        shd.reset_collective_counts()
        new, met = tp.pame_step(shd.shard_tree(state, place, sizes, coord),
                                tp.shard_batch(inputs["batch"], sharded, grad_fn), grad_fn,
                                arrs, pcfg, param_shardings=sharded, draws=draws)
        return new.params, met, grads

    if world == 1:
        out = {}
        for case in cases:
            ones = {"node": 1, "fsdp": 1, "model": 1}
            (pu, mu, gu), (ps, ms, gs) = step(case, None), step(case, ones)
            out[case] = (all(torch.equal(a, b) for a, b in zip(tree_leaves(pu), tree_leaves(ps)))
                         and all(torch.equal(a, b) for x, y in zip(gu, gs) for a, b in zip(x, y))
                         and torch.equal(mu["loss_mean"], ms["loss_mean"]) and len(gu) == 4)
        torch.save(out, os.path.join(work, "one_rank.pt"))
    else:
        out = {}
        for case in cases:
            sizes = dict(zip(("node", "fsdp", "model"), map(int, case.split("@")[1].split("x"))))
            params, met, grads = step(case, sizes)
            out[case] = {"params": tree_leaves(params), "loss_mean": met["loss_mean"],
                         "grads": grads, "collectives": shd.collective_counts()}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.barrier()
    dist.destroy_process_group()
    print("RANK OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _unsharded(stacked, batch, draws, model, ex):
    """The port's unsharded step: (new leaves, loss_mean, each node's
    gradient leaves)."""
    from repro_torch.configs import get_config
    from repro_torch.core import pame as tp
    from repro_torch.core.topology import build_topology
    from repro_torch.launch.train import lm_grad_fn
    from repro_torch.tree import tree_leaves, tree_map

    arch, _, mod = model.partition("+")
    cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
    inner, grads = lm_grad_fn(cfg), []

    def grad_fn(p, b, k, view=None):
        loss, g = inner(p, b, k, view=view)
        grads.append([x.clone() for x in tree_leaves(g)])
        return loss, g

    exchange, mixing = EXCHANGES[ex]
    pcfg = tp.PaMEConfig(exchange=exchange, mixing=mixing, **HP)
    arrs = tp.make_topology_arrays(build_topology("ring", M), pcfg, device="cpu")
    state = tp.pame_init(1, tree_map(torch.clone, stacked), M, pcfg)
    new, met = tp.pame_step(state, batch, grad_fn, arrs, pcfg, draws=draws)
    return tree_leaves(new.params), met["loss_mean"], grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps (subprocess), the port's on 8 gloo ranks, the
    one-rank view against the unsharded step (a ninth process), and the
    port's unsharded steps (here)."""
    from repro.configs import get_config as jget_config
    from repro.core import pame as jpame
    from repro.core.topology import build_topology as jbuild
    from repro.models.model import init_params as jinit
    from repro_torch import convert
    from repro_torch.tree import tree_unflatten, tree_flatten

    work = str(tmp_path_factory.mktemp("tp_train"))
    vocab = min(jget_config(m.partition("+")[0], "smoke").vocab for m in MODELS)
    tokens = np.random.default_rng(0).integers(0, vocab, (M, B, S)).astype(np.int32)
    arrays, stacked_t, draws = {"tokens": tokens}, {}, {}
    for model in MODELS:
        arch, _, mod = model.partition("+")
        cfg = jget_config(arch, "smoke").replace(**MODS.get(mod, {}))
        stacked = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x[None], (M,) + x.shape),
                                         jinit(jax.random.PRNGKey(0), cfg))
        leaves, td = jax.tree_util.tree_flatten(stacked)
        rng = np.random.default_rng(1)
        leaves = [np.asarray(x) + (0.01 * rng.standard_normal(x.shape)).astype(x.dtype)
                  for x in leaves]
        arrays.update({f"{model}|p{i}": x for i, x in enumerate(leaves)})
        stacked = jax.tree_util.tree_unflatten(td, [jnp.asarray(x) for x in leaves])
        stacked_t[model] = convert.to_torch(jax.device_get(stacked))
        for ex, (exchange, mixing) in EXCHANGES.items():
            if not any(c.startswith(f"{model}@") and c.endswith(f"@{ex}") for c in CASES):
                continue
            jcfg = jpame.PaMEConfig(exchange=exchange, mixing=mixing, **HP)
            arrs = jpame.make_topology_arrays(jbuild("ring", M), jcfg)
            draws[f"{model}@{ex}"] = jax_step_draws(jax.random.PRNGKey(1), 0, stacked, arrs,
                                                    jcfg)
    np.savez(os.path.join(work, "inputs.npz"), **arrays)
    t_batch = {"tokens": torch.as_tensor(tokens)}
    torch.save({"stacked": stacked_t, "batch": t_batch, "draws": draws, "hp": HP},
               os.path.join(work, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", JAX_CODE, work, str(k),
                               *CASES[k::JAX_PROCS]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for k in range(JAX_PROCS)]
    port = str(_free_port())
    procs += [subprocess.Popen([sys.executable, "-c", RANK_CODE, work, str(r), "8", port,
                                *CASES], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True, env=env) for r in range(8)]
    one = [f"{model}@1x1x1@dense" for model in MODELS]
    procs.append(subprocess.Popen([sys.executable, "-c", RANK_CODE, work, "0", "1",
                                   str(_free_port()), *one], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True, env=env))
    # one torch thread, as in the ranks: the CPU's multithreaded embedding
    # backward sums in no fixed order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        unsharded = {}
        for case in CASES:
            model, _, ex = case.split("@")
            if (model, ex) not in unsharded:
                unsharded[model, ex] = _unsharded(stacked_t[model], t_batch,
                                                  draws[f"{model}@{ex}"], model, ex)
    finally:
        torch.set_num_threads(threads)
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    jax_out = {}
    for k in range(JAX_PROCS):
        jax_out.update(np.load(os.path.join(work, f"jax{k}.npz")))
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(8)]
    return jax_out, ranks, unsharded, torch.load(os.path.join(work, "one_rank.pt"))


def _node_specs(model, sizes):
    """Each leaf's placement within one node (the node entry dropped)."""
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    arch, _, mod = model.partition("+")
    cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
    params = init_params(0, cfg, device="cpu")
    specs = shd.params_shardings(params, sizes, node_stacked=False)
    return shd.leaf_specs(params, specs)


def _node_grads(ranks, case, sizes, like):
    """Each node's gradient leaves assembled from the ranks' pieces (each
    rank records its nodes' gradients in order), and whether every rank's
    piece is the assembled gradient's piece (a piece held by several ranks
    is the same on each)."""
    from repro_torch import sharding as shd

    specs = _node_specs(case.split("@")[0], sizes)
    per = M // sizes["node"]
    out = [[w.new_full(w.shape, float("nan")) for w in like] for _ in range(M)]
    for rank, res in enumerate(ranks):
        coord = shd.rank_coords(rank, sizes)
        for k, g in enumerate(res[case]["grads"]):
            for j, piece in enumerate(g):
                shd.cut(out[coord["node"] * per + k][j], specs[j], sizes, coord).copy_(piece)
    agree = all(torch.equal(piece, shd.cut(out[shd.rank_coords(rank, sizes)["node"] * per + k][j],
                                           specs[j], sizes, shd.rank_coords(rank, sizes)))
                for rank, res in enumerate(ranks)
                for k, g in enumerate(res[case]["grads"]) for j, piece in enumerate(g))
    return out, agree


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_sharded(runs, case):
    """Every leaf of the new state, assembled from the 8 ranks' pieces, and
    loss_mean within 1e-5 of JAX's sharded step on the same mesh."""
    from repro_torch import sharding as shd

    jax_out, ranks, _, _ = runs
    sizes = dict(zip(("node", "fsdp", "model"), LAYOUTS[case.split("@")[1]]))
    n = len(ranks[0][case]["params"])
    assert f"{case}|{n - 1}" in jax_out and f"{case}|{n}" not in jax_out
    for j in range(n):
        want = jax_out[f"{case}|{j}"]
        got = torch.empty(want.shape, dtype=ranks[0][case]["params"][j].dtype)
        spec = ("node",) + tuple(_node_specs(case.split("@")[0], sizes)[j])
        for rank, res in enumerate(ranks):
            shd.cut(got, spec, sizes, shd.rank_coords(rank, sizes)).copy_(res[case]["params"][j])
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL, err_msg=f"leaf {j}")
    for res in ranks:
        assert abs(float(res[case]["loss_mean"]) - float(jax_out[f"{case}|loss"])) < TOL


# the compressed exchanges sharded are not the unsharded ones where a leaf's
# axis 1 is placed (ROADMAP, queue 3): their gradients are taken elsewhere
@pytest.mark.parametrize("case", [c for c in CASES if "compressed" not in c])
def test_tp_node_gradients_match_unsharded(runs, case):
    """Every node's gradient, assembled from the ranks' pieces, within 1e-5
    of the port's unsharded step's, leaf by leaf; a piece several ranks
    hold (a leaf replicated over `model`, say) is the same on each, and the
    loss_mean is the unsharded step's to f32 rounding."""
    _, ranks, unsharded, _ = runs
    model, layout, ex = case.split("@")
    sizes = dict(zip(("node", "fsdp", "model"), LAYOUTS[layout]))
    _, loss, want = unsharded[model, ex]
    got, agree = _node_grads(ranks, case, sizes, want[0])
    assert agree
    for i in range(M):
        for j, (g, w) in enumerate(zip(got[i], want[i])):
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=0, atol=TOL,
                                       err_msg=f"node {i} leaf {j}")
    assert abs(float(ranks[0][case]["loss_mean"]) - float(loss)) < TOL


@pytest.mark.parametrize("layout", ["1x2x4", "2x2x2"])
def test_tp_step_collectives(runs, layout):
    """The gradient is reduce-scattered over fsdp (its only all-gather is
    the layers' "weights"), the forward and backward over `model` go by
    all-reduces of activations, and no rank gathers a node's whole leaves."""
    _, ranks, _, _ = runs
    for model in MODELS:
        for res in ranks:
            c = res[f"{model}@{layout}@dense"]["collectives"]
            assert set(c["all_gather"]["by_use"]) <= {"exchange", "weights", "logits",
                                                        "metrics", "routing"}
            assert c["reduce_scatter"]["by_use"]["gradient"] > 0
            assert set(c["reduce_scatter"]["by_use"]) == {"gradient"}
            assert c["all_reduce"]["by_use"]["activations"] > 0


@pytest.mark.parametrize("model", MODELS)
def test_one_rank_view_bit_equal_to_unsharded(runs, model):
    """On a (1, 1, 1) mesh of one gloo rank the tensor-parallel step gives
    the unsharded step's state, loss_mean and every node's gradient bit for
    bit."""
    assert runs[3][f"{model}@1x1x1@dense"]


def test_chip_smoke_path_m_rehearsal(tmp_path):
    """Path M of chip_smoke.py on gloo CPU ranks at the smoke config in
    bf16 (no kernel on the CPU): M1 on two ranks at (1, 1, 2), dense and
    sparse, M2 on four at (1, 2, 2) and 8 layers, dense; every node's
    gradient (largest difference and relative norm) and the new state
    (relative norm) of the tensor-parallel step within `M_ERROR_RATIO`
    (1.25) of bf16's own distance from f32 of the gather-whole route's,
    which equals the unsharded step's, and loss_mean within `M_LOSS_REL`;
    M2's negative control (one entry left out) above the bound.  And J5's
    path-M dry run at the smoke size: rank 0's collective bytes by use are
    the dry run's."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    rows, launches = cs.path_m(torch.device("cpu"), variant="smoke")
    assert launches == {"pme_average": 0, "pme_average_range": 0, "f32": 0}
    assert sorted(rows) == ["M1", "M2"]
    assert [len(rows[run]["ranks"]) for run in ("M1", "M2")] == [2, 4]
    (name, argv), = [c for c in cs.m_dry_combos() if c[0] == "M-M2"]
    recs = cs.run_dryruns(80e9, str(tmp_path), [(name, argv + ["--size", "smoke"])])
    got = {kind: c["by_use"] for kind, c in rows["M2"]["ranks"][0]["collectives"].items()}
    assert recs[name]["by_use"] == got
    assert got["reduce_scatter"]["gradient"] > 0 and "gradient" not in got["all_gather"]
    assert recs[name]["per_device_memory"]["peak_bytes"] > 0
