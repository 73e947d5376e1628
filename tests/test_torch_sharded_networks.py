"""The port's sharded PaME step under a dynamic network on 8 gloo ranks,
against JAX's sharded step on 8 fake XLA host devices.

JAX's side is one subprocess with 8 fake host devices that jits
`repro.core.pame.pame_step(..., param_shardings=state_sh.params,
realization=, self_params=, delivered=)` with the state placed by
`repro.sharding.state_shardings` (and the self view by its params'
placements), as `tests/test_torch_distributed.py` runs the static step.
The port's side is one world of 8 gloo processes on 127.0.0.1: each rank
holds its pieces of the state and of the fresh stack, the realization and
the delivery masks whole, JAX's draws injected (the realized selection).

The network, on m = 4 nodes of path A's graph (Erdős–Rényi p = 0.5, seed 0:
edges 0–1, 0–2, 0–3, 2–3): node 1 offline, the edge 2–3 down, nodes 2 and 3
late by one step and read at the ring's snapshot of the step before (the
temporal scenario's delayed stragglers, which take part through their stale
rows), node 3's message from node 0 lost (``delivered``), so that node 3's
whole average is its fresh fill.  Smoke stablelm-1.6b in f32: the previous
stack is JAX's params0 stacked plus 0.01 · N(0, 1) numpy noise (seed 1), the
fresh stack that plus 0.01 · N(0, 1) (seed 2), and the delayed stack the
fresh one with nodes 2 and 3 taken from `temporal.ring_init` /
`ring_push` (each rank builds its own from its pieces and must get the
unsharded ring's pieces).

Held: every leaf and ``loss_mean`` within 1e-5 of JAX's sharded step and
``wire_bits`` equal to JAX's, for the dense exchange under a realization,
the sparse one under a realization, delivery masks and the self view, the
dense one with the self view, and the compressed and int8 exchanges under
a realization, at 4 × 1 × 2 with exact masks; the sparse network case on
the tensor-parallel route (`lm_grad_fn`) at 2 × 2 × 2.  The dense and
sparse cases, and the self-view cases with Bernoulli masks, are also
bit-equal to the port's unsharded step, ``wire_bits`` included.  `scenarios.freeze_dropped(...,
shardings=)` on every rank equals JAX's `freeze_dropped` on the sharded
arrays.  One JAX subprocess and one world serve every case, beside each
other; each case is its own test.
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
M, RANKS, TOL = 4, 8, 1e-5
GRAPH = ("erdos_renyi", M, {"p": 0.5, "seed": 0})
HP = dict(nu=0.5, p=0.25, gamma=1.01, sigma0=20.0, homogeneous_kappa=2)
OFFLINE, LATE, EDGE_DOWN, LOST = 1, (2, 3), (2, 3), (3, 0)  # LOST: (receiver, sender)
STALENESS = 2  # the ring's depth; the late nodes are read one step back
# case: (exchange, mixing, mask mode, layout, the network's inputs the step
# takes: "r" realization, "d" delivered, "s" self view, "tp" the
# tensor-parallel route)
CASES = {
    "dense-real": ("dense", "dense", "exact", "4x1x2", "r"),
    "sparse-net": ("dense", "sparse", "exact", "4x1x2", "rds"),
    "sparse-net-bernoulli": ("dense", "sparse", "bernoulli", "4x1x2", "rds"),
    "dense-self": ("dense", "dense", "exact", "4x1x2", "rs"),
    "dense-self-bernoulli": ("dense", "dense", "bernoulli", "4x1x2", "rs"),
    "compressed-real": ("compressed", "dense", "exact", "4x1x2", "r"),
    "compressed_q8-real": ("compressed_q8", "dense", "exact", "4x1x2", "r"),
    "tp-sparse-net": ("dense", "sparse", "exact", "2x2x2", "rds+tp"),
}
BIT_EQUAL = ("dense-real", "sparse-net", "sparse-net-bernoulli", "dense-self",
             "dense-self-bernoulli")
# the cases JAX's side runs (it compiles a sharded step a case, the suite's
# slowest part here): the Bernoulli forms of the self-view cases are held to
# the port's unsharded step bit for bit instead
JAX_CASES = {k: v for k, v in CASES.items() if not k.endswith("-bernoulli")}
JAX_PROCS = 2

JAX_CODE = f"CASES = {JAX_CASES!r}\nHP = {HP!r}\n" + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.launch.mesh import mesh_axis_kwargs
    from repro.configs import get_config
    from repro.core import scenarios as JS
    from repro.core.pame import PaMEConfig, PaMEState, pame_init, pame_step, make_topology_arrays
    from repro.core.topology import build_topology
    from repro.models.model import init_params, train_loss
    from repro import sharding as shd

    work, part, cases = sys.argv[1], sys.argv[2], sys.argv[3:]
    data = np.load(os.path.join(work, "inputs.npz"))
    cfg = get_config("stablelm-1.6b", "smoke")
    td = jax.tree_util.tree_structure(init_params(jax.random.PRNGKey(0), cfg))
    stack = lambda name: jax.tree_util.tree_unflatten(
        td, [jnp.asarray(data[f"{name}{i}"]) for i in range(td.num_leaves)])
    prev, fresh, delayed = stack("prev"), stack("fresh"), stack("delayed")
    batch = {"tokens": jnp.asarray(data["tokens"])}
    topo = build_topology("erdos_renyi", 4, p=0.5, seed=0)
    arrays = JS.make_scenario_arrays(topo, JS.Scenario())
    real = JS.realization_from_masks(arrays, jnp.asarray(data["edge_up"]),
                                     jnp.asarray(data["alive"]), jnp.asarray(data["straggler"]))
    delivered = jnp.asarray(data["delivered"])
    sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)

    def grad_fn(p, b, k):
        return jax.value_and_grad(lambda pp: train_loss(pp, cfg, b))(p)

    def placed(layout, state):
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(tuple(map(int, layout.split("x")))),
                    ("node", "fsdp", "model"), **mesh_axis_kwargs(3))
        state_sh = shd.state_shardings(jax.tree_util.tree_map(sds, state), mesh)
        batch_sh = shd.batch_shardings(jax.tree_util.tree_map(sds, batch), mesh, True)
        return mesh, state_sh, batch_sh

    out = {}
    for case in cases:
        if case == "freeze":
            continue
        exchange, mixing, mode, layout, inputs = CASES[case]
        pcfg = PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **HP)
        arrs = make_topology_arrays(topo, pcfg)
        selfv = "s" in inputs
        state = pame_init(jax.random.PRNGKey(1), delayed if selfv else fresh, 4, pcfg)
        mesh, state_sh, batch_sh = placed(layout, state)
        kw = dict(param_shardings=state_sh.params, realization=real,
                  delivered=delivered if "d" in inputs else None)
        with mesh:
            fn = jax.jit(lambda s, b, sp: pame_step(s, b, grad_fn, arrs, pcfg, self_params=sp,
                                                    **kw),
                         in_shardings=(state_sh, batch_sh, state_sh.params if selfv else None))
            new, met = fn(jax.device_put(state, state_sh), jax.device_put(batch, batch_sh),
                          jax.device_put(fresh, state_sh.params) if selfv else None)
        for i, leaf in enumerate(jax.tree_util.tree_leaves(new.params)):
            out[f"{case}|{i}"] = np.asarray(leaf)
        for name in ("loss_mean", "wire_bits", "comm_nodes"):
            out[f"{case}|{name}"] = np.asarray(met[name])
    if "freeze" in cases:
        # freeze_dropped on the sharded arrays: the previous state against a
        # new one holding the fresh stack, at 4 x 1 x 2
        pcfg = PaMEConfig(**HP)
        old = pame_init(jax.random.PRNGKey(1), prev, 4, pcfg)
        new = PaMEState(params=fresh, sigma=old.sigma * 1.5, step=old.step + 1, key=old.key)
        mesh, state_sh, _ = placed("4x1x2", old)
        with mesh:
            frozen = jax.jit(lambda o, n: JS.freeze_dropped(real.alive, o, n),
                             in_shardings=(state_sh, state_sh))(jax.device_put(old, state_sh),
                                                               jax.device_put(new, state_sh))
        for i, leaf in enumerate(jax.tree_util.tree_leaves(frozen.params)):
            out[f"freeze|{i}"] = np.asarray(leaf)
        out["freeze|sigma"] = np.asarray(frozen.sigma)
    np.savez(os.path.join(work, f"jax{part}.npz"), **out)
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
    from repro_torch.core import pame as tp, pme, scenarios as TS, temporal as TT
    from repro_torch.core.topology import build_topology
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.launch.train import lm_grad_fn
    from repro_torch.models.model import train_loss
    from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    cfg = get_config("stablelm-1.6b", "smoke")
    topo = build_topology("erdos_renyi", 4, p=0.5, seed=0)
    real = TS.realization_from_masks(TS.make_scenario_arrays(topo, TS.Scenario()),
                                     inputs["edge_up"], inputs["alive"], inputs["straggler"])

    def whole_fn(p, b, k):
        leaves, td = tree_flatten(p)
        loss = train_loss(p, cfg, b)
        return loss.detach(), tree_unflatten(td, list(torch.autograd.grad(loss, leaves)))

    meshes = {}

    def mesh_of(layout):
        if layout not in meshes:
            sizes = dict(zip(("node", "fsdp", "model"), map(int, layout.split("x"))))
            meshes[layout] = (sizes, make_logical_mesh(device_type="cpu", layout=sizes))
        sizes, mesh = meshes[layout]
        return sizes, mesh, shd.mesh_coords(mesh)

    def pieces(tree, place, sizes, coord):
        return shd.shard_tree(tree, place, sizes, coord)

    out = {}
    # the delayed stack on this rank from its own ring: the previous
    # stack's pieces seed it, nodes 2 and 3 read one step back, the fresh
    # pieces pushed into slot 1 (the unsharded ring's pieces slot by slot)
    sizes, mesh, coord = mesh_of("4x1x2")
    net_place = shd.state_shardings(tp.pame_init(1, inputs["fresh"], 4, tp.PaMEConfig()),
                                    sizes).params
    rows = shd.node_rows(shd.MeshShardings(mesh, net_place), 4)
    ring = TT.ring_init(pieces(inputs["prev"], net_place, sizes, coord), inputs["staleness"])
    fresh_p = pieces(inputs["fresh"], net_place, sizes, coord)
    delayed_p = tree_map(torch.clone, fresh_p)
    for x, r in zip(tree_leaves(delayed_p), tree_leaves(ring)):
        for i in inputs["late"]:
            if rows.start <= i < rows.stop:
                x[i - rows.start].copy_(r[(1 - 1) % inputs["staleness"]][i - rows.start])
    TT.ring_push(ring, fresh_p, 1, inputs["staleness"])
    out["ring_equal"] = all(
        torch.equal(r[slot], shd.cut(w[slot], spec, sizes, coord))
        for r, w, spec in zip(tree_leaves(ring), tree_leaves(inputs["ring"]),
                              shd.leaf_specs(fresh_p, net_place))
        for slot in range(inputs["staleness"]))
    out["delayed_equal"] = all(
        torch.equal(x, shd.cut(w, spec, sizes, coord))
        for x, w, spec in zip(tree_leaves(delayed_p), tree_leaves(inputs["delayed"]),
                              shd.leaf_specs(fresh_p, net_place)))

    for case, (exchange, mixing, mode, layout, net) in inputs["cases"].items():
        sizes, mesh, coord = mesh_of(layout)
        pcfg = tp.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **inputs["hp"])
        arrs = tp.make_topology_arrays(topo, pcfg, device="cpu")
        selfv = "s" in net
        state = tp.pame_init(1, inputs["delayed"] if selfv else inputs["fresh"], 4, pcfg)
        place = shd.state_shardings(state, sizes)
        sharded = shd.MeshShardings(mesh, place.params)
        grad_fn = lm_grad_fn(cfg) if "tp" in net else whole_fn
        local = pieces(state, place, sizes, coord)
        if selfv and layout == "4x1x2":  # the state's delayed pieces from the ring
            local = local._replace(params=delayed_p)
        new, met = tp.pame_step(
            local, tp.shard_batch(inputs["batch"], sharded, grad_fn), grad_fn, arrs, pcfg,
            param_shardings=sharded, realization=real,
            self_params=pieces(inputs["fresh"], place.params, sizes, coord) if selfv else None,
            delivered=inputs["delivered"] if "d" in net else None,
            draws=inputs["draws"][case])
        out[case] = {"params": shd.gather_tree(new.params, sharded),
                     **{k: met[k] for k in ("loss_mean", "wire_bits", "comm_nodes",
                                             "sigma_mean")}}

    # the sparse network case's exchange alone: node 3 hears nobody (its
    # one message lost), so the rank that holds it must fill its rows from
    # its fresh pieces, not from the delayed rows the gathered senders hold
    sizes, mesh, coord = mesh_of("4x1x2")
    sharded = shd.MeshShardings(mesh, net_place)
    arrs = tp.make_topology_arrays(topo, tp.PaMEConfig(**inputs["hp"]), device="cpu")
    draws = inputs["draws"]["sparse-net"]
    v_bar = pme.pme_average_pytree_padded(
        None, delayed_p, arrs.nbrs, draws["sel"] & inputs["delivered"], inputs["hp"]["p"],
        mode="exact", pad=~arrs.valid, self_params=fresh_p, masks=draws["masks"],
        shardings=sharded)
    out["fill"] = None
    if rows.start <= 3 < rows.stop:
        i = 3 - rows.start
        out["fill"] = all(torch.equal(v[i], f[i]) and not torch.equal(v[i], d[i])
                          for v, f, d in zip(tree_leaves(v_bar), tree_leaves(fresh_p),
                                             tree_leaves(delayed_p)))

    # freeze_dropped on this rank's pieces: the previous state against a new
    # one holding the fresh stack; with the mesh's shardings and with the
    # rank's Local view
    old = tp.pame_init(1, inputs["prev"], 4, tp.PaMEConfig(**inputs["hp"]))
    place = shd.state_shardings(old, sizes)
    sharded = shd.MeshShardings(mesh, place.params)
    old_p = pieces(old, place, sizes, coord)
    frozen = {}
    for how, sh in (("mesh", sharded), ("local", shd.local_view(sharded, old_p.params))):
        new = tp.PaMEState(params=pieces(inputs["fresh"], place.params, sizes, coord),
                           sigma=old_p.sigma * 1.5, step=1, key=1)
        new = TS.freeze_dropped(real.alive, old_p, new, shardings=sh)
        frozen[how] = {"params": shd.gather_tree(new.params, sharded),
                       "sigma": shd.all_gather(new.sigma, mesh, "node")}
    out["freeze"] = frozen
    out["freeze_rows"] = [(i, tuple(r.shape)) for _, i, r in
                          TS.dropped_rows(real.alive, old_p, shardings=sharded)]
    try:  # a whole state where the rank holds one node's rows
        TS.dropped_rows(real.alive, old, shardings=sharded)
        out["whole_state_raises"] = None
    except ValueError as e:
        out["whole_state_raises"] = str(e)
    try:  # an [L, m, m] lane selection on a sharded exchange
        pme.pme_average_pytree(0, old_p.params, torch.zeros(2, 4, 4), 0.25,
                               shardings=sharded)
        out["lanes_raise"] = None
    except NotImplementedError as e:
        out["lanes_raise"] = str(e)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK OK", rank)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _network(jnbrs):
    """The network's masks from the graph's padded table: (edge_up [m, d],
    alive [m], straggler [m], delivered [m, d]), numpy bool."""
    nbrs = np.asarray(jnbrs)
    edge_up = np.ones(nbrs.shape, bool)
    a, b = EDGE_DOWN
    edge_up[a, list(nbrs[a]).index(b)] = edge_up[b, list(nbrs[b]).index(a)] = False
    alive = np.ones(M, bool)
    alive[OFFLINE] = False
    delivered = np.ones(nbrs.shape, bool)
    recv, send = LOST
    delivered[recv, list(nbrs[recv]).index(send)] = False
    return edge_up, alive, np.zeros(M, bool), delivered


def _port_step(case, inputs, real):
    """The port's unsharded step of `case` on the same inputs and draws."""
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

    exchange, mixing, mode, _, net = CASES[case]
    pcfg = tp.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **HP)
    arrs = tp.make_topology_arrays(build_topology(GRAPH[0], M, **GRAPH[2]), pcfg, device="cpu")
    selfv = "s" in net
    state = tp.pame_init(1, tree_map(torch.clone, inputs["delayed" if selfv else "fresh"]), M,
                         pcfg)
    return tp.pame_step(state, inputs["batch"], grad_fn, arrs, pcfg, realization=real,
                        self_params=inputs["fresh"] if selfv else None,
                        delivered=inputs["delivered"] if "d" in net else None,
                        draws=inputs["draws"][case])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps and freeze (subprocess), the port's on 8 gloo
    ranks, and the port's unsharded steps of the BIT_EQUAL cases."""
    from repro.configs import get_config as jget_config
    from repro.core import pame as jpame
    from repro.core import scenarios as JS
    from repro.core.topology import build_topology as jbuild
    from repro.models.model import init_params as jinit
    from repro_torch import convert
    from repro_torch.core import scenarios as TS
    from repro_torch.core import temporal as TT
    from repro_torch.core.topology import build_topology
    from repro_torch.tree import tree_leaves, tree_map

    work = str(tmp_path_factory.mktemp("sharded_networks"))
    cfg = jget_config("stablelm-1.6b", "smoke")
    leaves, td = jax.tree_util.tree_flatten(jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (M,) + x.shape), jinit(jax.random.PRNGKey(0), cfg)))
    rng1, rng2 = np.random.default_rng(1), np.random.default_rng(2)
    prev = [np.asarray(x) + (0.01 * rng1.standard_normal(x.shape)).astype(x.dtype)
            for x in leaves]
    fresh = [x + (0.01 * rng2.standard_normal(x.shape)).astype(x.dtype) for x in prev]
    t_prev = convert.to_torch(jax.tree_util.tree_unflatten(td, prev))
    t_fresh = convert.to_torch(jax.tree_util.tree_unflatten(td, fresh))
    # the unsharded ring: the previous stack seeds it, the late nodes read
    # one step back (slot 0 at k = 1), the fresh stack pushed into slot 1
    ring = TT.ring_init(t_prev, STALENESS)
    t_delayed = tree_map(torch.clone, t_fresh)
    for x, r in zip(tree_leaves(t_delayed), tree_leaves(ring)):
        for i in LATE:
            x[i].copy_(r[(1 - 1) % STALENESS][i])
    TT.ring_push(ring, t_fresh, 1, STALENESS)
    delayed = [to_np(x) for x in tree_leaves(t_delayed)]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (M, 2, 32)).astype(np.int32)
    topo = jbuild(GRAPH[0], M, **GRAPH[2])
    edge_up, alive, straggler, delivered = _network(topo.neighbor_matrix_padded()[0])
    np.savez(os.path.join(work, "inputs.npz"), tokens=tokens, edge_up=edge_up, alive=alive,
             straggler=straggler, delivered=delivered,
             **{f"{n}{i}": x for n, xs in (("prev", prev), ("fresh", fresh),
                                           ("delayed", delayed)) for i, x in enumerate(xs)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    # JAX's cases split over JAX_PROCS subprocesses (a compile a case)
    jobs = list(JAX_CASES) + ["freeze"]
    jax_procs = [subprocess.Popen([sys.executable, "-c", JAX_CODE, work, str(part),
                                   *jobs[part::JAX_PROCS]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env) for part in range(JAX_PROCS)]
    # JAX's realized draws of each case (the selection under the realization)
    jreal = JS.realization_from_masks(JS.make_scenario_arrays(topo, JS.Scenario()),
                                      jnp.asarray(edge_up), jnp.asarray(alive),
                                      jnp.asarray(straggler))
    jdelayed = jax.tree_util.tree_unflatten(td, [jnp.asarray(x) for x in delayed])
    draws = {}
    for case, (exchange, mixing, mode, _, _) in CASES.items():
        jcfg = jpame.PaMEConfig(mask_mode=mode, exchange=exchange, mixing=mixing, **HP)
        draws[case] = jax_step_draws(jax.random.PRNGKey(1), 0, jdelayed,
                                     jpame.make_topology_arrays(topo, jcfg), jcfg,
                                     realization=jreal)
    inputs = {"prev": t_prev, "fresh": t_fresh, "delayed": t_delayed, "ring": ring,
              "batch": {"tokens": torch.as_tensor(tokens)}, "draws": draws, "cases": CASES,
              "hp": HP, "late": LATE, "staleness": STALENESS,
              "edge_up": torch.as_tensor(edge_up), "alive": torch.as_tensor(alive),
              "straggler": torch.as_tensor(straggler),
              "delivered": torch.as_tensor(delivered)}
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    port = str(_free_port())
    ranks = [subprocess.Popen([sys.executable, "-c", RANK_CODE, work, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(RANKS)]
    real = TS.realization_from_masks(
        TS.make_scenario_arrays(build_topology(GRAPH[0], M, **GRAPH[2]), TS.Scenario()),
        inputs["edge_up"], inputs["alive"], inputs["straggler"])
    # one torch thread, as in the ranks: the CPU's multithreaded embedding
    # backward sums in no fixed order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        unsharded = {case: _port_step(case, inputs, real) for case in BIT_EQUAL}
    finally:
        torch.set_num_threads(threads)
    logs = []
    try:
        for proc in jax_procs + ranks:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in jax_procs + ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(jax_procs + ranks, logs):
        assert proc.returncode == 0, log[-3000:]
    jax_out = {}
    for part in range(JAX_PROCS):
        jax_out.update(np.load(os.path.join(work, f"jax{part}.npz")))
    port_out = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(RANKS)]
    return jax_out, port_out, unsharded, inputs, len(leaves)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_sharded_network_step_matches_jax_sharded(runs, case):
    """Every leaf and loss_mean within 1e-5 of JAX's sharded step under the
    network, on every rank; wire_bits and the communicating nodes equal."""
    from repro_torch.tree import tree_leaves

    jax_out, port_out, _, _, n_leaves = runs
    for rank_out in port_out:
        got = rank_out[case]
        got_leaves = tree_leaves(got["params"])
        assert len(got_leaves) == n_leaves
        for i, g in enumerate(got_leaves):
            want = jax_out[f"{case}|{i}"]
            assert tuple(g.shape) == want.shape
            np.testing.assert_allclose(to_np(g), want, rtol=0, atol=TOL)
        assert abs(float(got["loss_mean"]) - float(jax_out[f"{case}|loss_mean"])) < TOL
        assert float(got["wire_bits"]) == float(jax_out[f"{case}|wire_bits"]) > 0
        assert int(got["comm_nodes"]) == int(jax_out[f"{case}|comm_nodes"]) == M - 1


@pytest.mark.parametrize("case", BIT_EQUAL)
def test_sharded_network_step_bit_equal_to_unsharded(runs, case):
    """The dense and sparse exchanges under the network, sharded, give the
    port's unsharded step bit for bit: the state, loss_mean, sigma_mean and
    the realized wire_bits (priced at the whole leaves, not the pieces)."""
    from repro_torch.tree import tree_leaves

    _, port_out, unsharded, _, _ = runs
    want_state, want_met = unsharded[case]
    got = port_out[0][case]
    for g, w in zip(tree_leaves(got["params"]), tree_leaves(want_state.params)):
        assert torch.equal(g, w)
    for name in ("loss_mean", "sigma_mean", "wire_bits"):
        assert torch.equal(got[name], want_met[name]), name


def test_self_view_fills_from_the_fresh_rows(runs):
    """The sparse network case's exchange alone on the ranks: node 3 hears
    nobody (its one message lost), and the rank that holds it fills its
    rows from its pieces of the fresh stack, not from the delayed rows the
    gathered senders hold (which differ)."""
    _, port_out, _, _, _ = runs
    fills = [r["fill"] for r in port_out if r["fill"] is not None]
    assert fills == [True, True]  # node 3's two model ranks at 4 x 1 x 2


def test_ring_on_a_rank_matches_the_unsharded_ring(runs):
    """`temporal.ring_init` / `ring_push` on a rank's pieces hold the
    unsharded ring's pieces slot by slot, and the delayed stack built from
    them is the unsharded one's pieces row for row."""
    _, port_out, _, _, _ = runs
    assert all(r["ring_equal"] and r["delayed_equal"] for r in port_out)


def test_freeze_dropped_sharded_matches_jax(runs):
    """`scenarios.freeze_dropped(..., shardings=)` on every rank's pieces
    (with the mesh's shardings and with the rank's Local view) equals JAX's
    `freeze_dropped` on the sharded arrays bit for bit: the offline node's
    rows of every leaf and of sigma back, the others new.  Only the rank
    that holds the offline node saves rows, and a whole state where the
    rank holds one node's rows raises."""
    from repro_torch.tree import tree_leaves

    jax_out, port_out, _, inputs, n_leaves = runs
    prev = tree_leaves(inputs["prev"])
    for rank, rank_out in enumerate(port_out):
        for how in ("mesh", "local"):
            got = rank_out["freeze"][how]
            leaves = tree_leaves(got["params"])
            for i in range(n_leaves):
                np.testing.assert_array_equal(to_np(leaves[i]), jax_out[f"freeze|{i}"])
                assert torch.equal(leaves[i][OFFLINE], prev[i][OFFLINE])
            np.testing.assert_array_equal(to_np(got["sigma"]), jax_out["freeze|sigma"])
        # 4 x 1 x 2: rank (node, 0, model) holds node `node`; it saves the
        # offline node's row of every leaf and of sigma, the others nothing
        rows = rank_out["freeze_rows"]
        assert len(rows) == (n_leaves + 1 if rank // 2 == OFFLINE else 0)
        assert all(i == OFFLINE for i, _ in rows)
        assert "holds all 4 node rows" in rank_out["whole_state_raises"]


def test_sharded_lanes_still_raise(runs):
    """A lane selection on a sharded exchange still raises, and says that
    JAX shards no lanes either."""
    _, port_out, _, _, _ = runs
    assert all("JAX shards none" in r["lanes_raise"] for r in port_out)


def test_chip_smoke_path_n_rehearsal():
    """Path N of chip_smoke.py on the CPU at the smoke config deepened to
    N_LAYERS: two gloo ranks at (2, 1, 1), each holding two of the four
    nodes, the three network cases on the tensor-parallel route (path K
    holds the gather-whole route) bit-equal to the parent's unsharded steps
    (wire_bits too) and `freeze_dropped(shardings=)` giving the offline
    node's rows back (no kernel launched on the CPU)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    rows, launches = cs.path_n(torch.device("cpu"), variant="smoke")
    assert launches["pme_average"] == launches["pme_average_range"] == launches["f32"] == 0
    assert sorted(r["rank"] for r in rows["ranks"]) == [0, 1]
    for r in rows["ranks"]:
        assert r["freeze_restored"] and all(c["bit_equal"] for c in r["cases"].values())
