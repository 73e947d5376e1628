"""The port's sharded prefill and decode on 8 gloo ranks against JAX's
sharded prefill and decode on 8 fake XLA host devices.

JAX's side is one subprocess with ``--xla_force_host_platform_device_count=8``
that jits `repro.models.model.prefill` and `decode_step` with
`in_shardings` from `repro.sharding` (parameters ``node_stacked=False``,
the batch's rows over (node, fsdp), the caches by `cache_shardings`, the
position replicated), as JAX's dry run lowers them.  The port's side is one
world of 8 gloo processes on 127.0.0.1: each rank holds its pieces of the
same weights (`repro_torch.sharding.serving_shardings`, `shard_tree`) and
runs `prefill(..., shardings=)` and 3 teacher-forced `decode_step`s on its
rows.  Weights are JAX's `init_params(PRNGKey(0))`, carried across with
`repro_torch.convert`; tokens come from one numpy seed.  Smoke configs in
f32: stablelm (4 heads), qwen3 (5 heads on 1 KV head: its wq / wk / wv are
cut inside a head over 4 ranks and gathered over `model`), zamba2 (the
hybrid: the fused Mamba projection gathered, the SSD on each rank's heads,
the shared block), mamba2 (fused, and with the split projections:
head-aligned pieces) and deepseek-v2-lite (MLA and expert-parallel MoE;
and at a capacity factor of 1.0, where experts overflow and choices are
dropped: the capacity and the drops are decided on the whole batch's
tokens, not a rank's rows), at (node, fsdp, model) = (1, 2, 4) and
(2, 2, 2).  Held: the
prefill logits and caches and each decode step's logits, assembled from
the ranks' pieces, within 1e-5 of JAX's.  A third process, one gloo rank
on a (1, 1, 1) mesh, holds the one-rank view bit for bit to the unsharded
prefill and decode.  One JAX subprocess and one world serve every case,
beside each other.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import to_np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a model "arch+mod" is the arch's smoke config with MODS[mod] replaced
ARCHS = {"stablelm": "stablelm-1.6b", "qwen3": "qwen3-14b", "zamba2": "zamba2-1.2b",
         "mamba2": "mamba2-1.3b", "mamba2-split": "mamba2-1.3b+split",
         "deepseek": "deepseek-v2-lite-16b", "deepseek-drop": "deepseek-v2-lite-16b+drop"}
MODS = {"split": {"ssm_split_proj": True},
        # 4 experts, top-2: a buffer holds T / 2 of a batch's T tokens
        "drop": {"capacity_factor": 1.0}}
LAYOUTS = {"1x2x4": (1, 2, 4), "2x2x2": (2, 2, 2)}
B, S, STEPS = 4, 16, 3
CAP = S + STEPS
TOL = 1e-5

JAX_CODE = f"MODS = {MODS!r}\n" + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.launch.mesh import mesh_axis_kwargs
    from repro.configs import get_config
    from repro.models.model import init_params, prefill, decode_step
    from repro import sharding as shd

    work, S, CAP, STEPS = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    cases = sys.argv[5:]
    tokens = np.load(os.path.join(work, "tokens.npy"))
    sds = lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype)
    out = {}
    for case in cases:
        model, layout = case.split("@")
        arch, _, mod = model.partition("+")
        cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
        params = init_params(jax.random.PRNGKey(0), cfg)
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(tuple(map(int, layout.split("x")))),
                    ("node", "fsdp", "model"), **mesh_axis_kwargs(3))
        batch = {"tokens": jnp.asarray(tokens[:, :S])}
        p_sh = shd.params_shardings(jax.tree_util.tree_map(sds, params), mesh, node_stacked=False)
        b_sh = shd.batch_shardings(jax.tree_util.tree_map(sds, batch), mesh, node_stacked=False)
        with mesh:
            pp = jax.device_put(params, p_sh)
            pf = jax.jit(lambda p, b: prefill(p, cfg, b, CAP), in_shardings=(p_sh, b_sh))
            logits, caches = pf(pp, jax.device_put(batch, b_sh))
            c_sh = shd.cache_shardings(jax.tree_util.tree_map(sds, caches), mesh)
            tok0 = jnp.asarray(tokens[:, S])
            t_sh = shd.batch_shardings(sds(tok0), mesh, node_stacked=False)
            dc = jax.jit(lambda p, t, pos, c: decode_step(p, cfg, t, pos, c),
                         in_shardings=(p_sh, t_sh, NamedSharding(mesh, P()), c_sh))
            out[f"{case}|prefill"] = np.asarray(logits)
            for i, leaf in enumerate(jax.tree_util.tree_leaves(caches)):
                out[f"{case}|cache{i}"] = np.asarray(leaf)
            for i in range(STEPS):
                # each call takes the caches placed as the dry run places them
                lg, caches = dc(pp, jnp.asarray(tokens[:, S + i]), jnp.int32(S + i),
                                jax.device_put(caches, c_sh))
                out[f"{case}|decode{i}"] = np.asarray(lg)
    np.savez(os.path.join(work, "jax.npz"), **out)
    print("JAX OK")
""")

RANK_CODE = f"MODS = {MODS!r}\n" + textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    work, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    S, CAP, STEPS = int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7])
    cases = sys.argv[8:]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models.model import decode_step, init_cache, prefill
    from repro_torch.tree import tree_leaves

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    tokens = inputs["tokens"]
    out = {}
    for case in cases:
        model, layout = case.split("@")
        arch, _, mod = model.partition("+")
        cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
        params = inputs["params"][model]
        sizes = dict(zip(("node", "fsdp", "model"), map(int, layout.split("x"))))
        mesh = make_logical_mesh(device_type="cpu", layout=sizes)
        coord = shd.mesh_coords(mesh)
        batch = {"tokens": tokens[:, :S]}
        sh = shd.serving_shardings(mesh, params, batch,
                                   init_cache(cfg, tokens.shape[0], CAP, device="meta"))
        mine = shd.shard_tree(params, sh.params, sizes, coord)
        rows = lambda x: shd.cut(x, sh.batch["tokens"][:1], sizes, coord)
        shd.reset_collective_counts()
        with torch.inference_mode():
            logits, caches = prefill(mine, cfg, shd.shard_tree(batch, sh.batch, sizes, coord),
                                     CAP, shardings=sh)
            res = {"prefill": logits.clone(),
                   "caches": [x.clone() for x in tree_leaves(caches)], "decode": []}
            for i in range(STEPS):
                lg, caches = decode_step(mine, cfg, rows(tokens[:, S + i]), S + i, caches,
                                         shardings=sh)
                res["decode"].append(lg.clone())
        res["collectives"] = shd.collective_counts()
        res["gathered"] = shd.gathered_over_model()
        out[case] = res
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print("RANK OK", rank)
""")

# one gloo rank: the (1, 1, 1) view against the unsharded step, bit for bit
ONE_CODE = f"MODS = {MODS!r}\n" + textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    torch.set_num_threads(1)
    work, port, S, CAP, STEPS = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), \\
        int(sys.argv[5])
    models = sys.argv[6:]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1)
    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_logical_mesh
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.tree import tree_leaves

    inputs = torch.load(os.path.join(work, "inputs.pt"))
    tokens = inputs["tokens"]
    mesh = make_logical_mesh(device_type="cpu", layout={"node": 1, "fsdp": 1, "model": 1})
    equal = {}
    for model in models:
        arch, _, mod = model.partition("+")
        cfg = get_config(arch, "smoke").replace(**MODS.get(mod, {}))
        params = inputs["params"][model]
        sh = shd.serving_shardings(mesh, params)
        runs = []
        for shardings in (None, sh):
            with torch.inference_mode():
                lg, caches = prefill(params, cfg, {"tokens": tokens[:, :S]}, CAP,
                                     shardings=shardings)
                outs = [lg.clone()] + [x.clone() for x in tree_leaves(caches)]
                for i in range(STEPS):
                    lg, caches = decode_step(params, cfg, tokens[:, S + i], S + i, caches,
                                             shardings=shardings)
                    outs.append(lg.clone())
                outs += tree_leaves(caches)
            runs.append(outs)
        equal[model] = all(torch.equal(a, b) for a, b in zip(*runs)) and \\
            len(runs[0]) == len(runs[1])
    torch.save(equal, os.path.join(work, "one_rank.pt"))
    dist.destroy_process_group()
    print("ONE OK")
""")

CASES = [f"{arch}@{layout}" for arch in ARCHS.values() for layout in LAYOUTS]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded prefill and decode (subprocess), the port's on 8 gloo
    ranks, and the one-rank view against the unsharded step."""
    from repro.configs import get_config as jget_config
    from repro.models.model import init_params as jinit
    from repro_torch import convert

    work = str(tmp_path_factory.mktemp("sharded_serving"))
    cfgs = {}
    for model in ARCHS.values():
        arch, _, mod = model.partition("+")
        cfgs[model] = jget_config(arch, "smoke").replace(**MODS.get(mod, {}))
    vocab = min(cfg.vocab for cfg in cfgs.values())
    tokens = np.random.default_rng(3).integers(0, vocab, (B, S + STEPS)).astype(np.int32)
    np.save(os.path.join(work, "tokens.npy"), tokens)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, work, str(S), str(CAP), str(STEPS),
         *CASES],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    params = {model: convert.to_torch(jax.device_get(jinit(jax.random.PRNGKey(0), cfg)))
              for model, cfg in cfgs.items()}
    torch.save({"tokens": torch.as_tensor(tokens), "params": params},
               os.path.join(work, "inputs.pt"))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE, work, str(r), "8", port,
                               str(S), str(CAP), str(STEPS), *CASES],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(8)]
    procs.append(subprocess.Popen([sys.executable, "-c", ONE_CODE, work, str(_free_port()),
                                   str(S), str(CAP), str(STEPS), *ARCHS.values()],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  env=env))
    procs.append(jax_proc)
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=300)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, log in zip(procs, logs):
        assert proc.returncode == 0, log[-3000:]
    jax_out = dict(np.load(os.path.join(work, "jax.npz")))
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt")) for r in range(8)]
    return jax_out, ranks, torch.load(os.path.join(work, "one_rank.pt"))


def _rows_whole(pieces, sizes, dim, batch):
    """Join the ranks' row pieces along `dim` (rows over (node, fsdp)
    jointly when `batch` divides by node · fsdp, as `batch_shardings`
    places them)."""
    from repro_torch import sharding as shd

    entry = shd.batch_shardings({"t": torch.empty(batch)}, sizes, node_stacked=False)["t"][0]
    spec = (None,) * dim + (entry,)
    whole_shape = list(pieces[0].shape)
    whole_shape[dim] = batch
    whole = pieces[0].new_empty(whole_shape)
    for rank, piece in enumerate(pieces):
        shd.cut(whole, spec, sizes, shd.rank_coords(rank, sizes)).copy_(piece)
    return whole


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_serving_matches_jax_sharded(runs, arch, layout):
    """Prefill logits and caches, and 3 decode steps' logits, assembled from
    the 8 ranks' pieces, within 1e-5 of JAX's sharded prefill and decode."""
    jax_out, ranks, _ = runs
    case = f"{ARCHS[arch]}@{layout}"
    sizes = dict(zip(("node", "fsdp", "model"), LAYOUTS[layout]))
    got = _rows_whole([r[case]["prefill"] for r in ranks], sizes, 0, B)
    np.testing.assert_allclose(to_np(got), jax_out[f"{case}|prefill"], rtol=0, atol=TOL)
    n_cache = len(ranks[0][case]["caches"])
    assert f"{case}|cache{n_cache - 1}" in jax_out and f"{case}|cache{n_cache}" not in jax_out
    for i in range(n_cache):
        want = jax_out[f"{case}|cache{i}"]
        pieces = [r[case]["caches"][i] for r in ranks]
        # [L, B, ...] leaves hold the rank's rows; a ring's positions [L, C] are whole
        got = pieces[0] if want.ndim == 2 else _rows_whole(pieces, sizes, 1, B)
        assert tuple(got.shape) == want.shape, (i, got.shape, want.shape)
        np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL, err_msg=f"cache {i}")
    for i in range(STEPS):
        got = _rows_whole([r[case]["decode"][i] for r in ranks], sizes, 0, B)
        np.testing.assert_allclose(to_np(got), jax_out[f"{case}|decode{i}"], rtol=0, atol=TOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_moe_capacity_binds_in_the_drop_case(runs, layout):
    """At a capacity factor of 1.0 the experts overflow: JAX's prefill and
    every decode step differ from the same weights' at deepseek-lite-smoke's
    own 4.0, where nothing is dropped.  So the drop case above holds the
    sharded capacity and drops, not only the routing."""
    jax_out, _, _ = runs
    for step in ("prefill", *(f"decode{i}" for i in range(STEPS))):
        drop = jax_out[f"{ARCHS['deepseek-drop']}@{layout}|{step}"]
        whole = jax_out[f"{ARCHS['deepseek']}@{layout}|{step}"]
        assert np.abs(drop - whole).max() > 1e3 * TOL, step


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_serving_collectives_and_gathers(runs, layout):
    """Every rank issued the serving uses' collectives; qwen3-smoke's
    mid-head cut gathers its wq / wk / wv over `model`, zamba2-smoke's fused
    Mamba projection and conv too, and the head-aligned pieces of
    stablelm-smoke and of mamba2-smoke's split projections nothing."""
    _, ranks, _ = runs
    by_use = {}
    for arch in ARCHS.values():
        c = ranks[0][f"{arch}@{layout}"]["collectives"]
        by_use[arch] = set(c["all_gather"]["by_use"]) | set(c["all_reduce"]["by_use"])
    assert {"activations", "embed", "logits", "cache", "weights"} <= by_use["stablelm-1.6b"]
    gathered = {arch: ranks[0][f"{arch}@{layout}"]["gathered"] for arch in ARCHS.values()}
    assert gathered["stablelm-1.6b"] == gathered["mamba2-1.3b+split"] == []
    if LAYOUTS[layout][2] == 4:
        assert any(p.endswith("attn/wk") for p in gathered["qwen3-14b"])
    assert any(p.endswith("mamba/in_proj") for p in gathered["zamba2-1.2b"])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_one_rank_view_bit_equal_to_unsharded(runs, arch):
    """On a (1, 1, 1) mesh of one gloo rank the sharded prefill and 3 decode
    steps give the unsharded ones' logits and caches bit for bit."""
    assert runs[2][ARCHS[arch]]


def test_chip_smoke_path_l_rehearsal(tmp_path):
    """Path L of chip_smoke.py on the CPU at the smoke configs (bf16, flash
    and SSD flags on: their plain versions here, no launch counted): L1 on
    one gloo rank, the sharded serving run bit-equal to the unsharded one;
    L2 on two gloo ranks at (1, 1, 2), the split prefill and its decode
    steps (fed the unsharded run's tokens) at most 1.5 times as far from
    the unsharded bf16 logits as those are from f32 (at these widths both
    are a bf16 ulp or two of the logits; the card holds 1.25), the prefill
    with the partial sums reduced in f32 at most 1.0 times and the one with
    a wrong head more than 1.5 times.  And one of J5's sharded serving
    combos (`j5_t8_arch`) at the smoke size."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    launches = cs.path_l(torch.device("cpu"), variant="smoke", ratio=1.5)
    assert sorted(launches) == sorted(row for rows in cs.L2_ROWS.values() for row in rows)
    assert all(n == {"flash": 0, "ssd": 0} for n in launches.values())
    combos = cs.j5_t8_combos()
    assert len(combos) == 10
    name, argv = combos[0]
    recs = cs.run_dryruns(80e9, str(tmp_path), [(name, argv + ["--size", "smoke"])])
    assert sorted(recs) == sorted(f"{name}-{shape}" for shape in cs.J5_T8_SHAPES)
    for rec in recs.values():
        assert rec["layout"]["model"] == 8 and rec["layout"]["devices"] == 8
        assert rec["bytes"]["all_reduce"] > 0
        assert rec["per_device_memory"]["peak_bytes"] > 0
