"""The port's layout arithmetic and placement rules against the JAX
package's `repro.launch.mesh` and `repro.sharding`, on the CPU.

`fsdp_degree` and `logical_layout` at JAX's own TPU values (the model axis
of 16 and the 8 GB parameter budget, passed explicitly) for every arch,
single- and multi-pod; `fit_spec` and `param_spec` on a duck-typed mesh
(what JAX's functions read of a mesh) for every parameter leaf of every
arch at the production layouts; and the tree functions, `per_device_bytes`
and `make_logical_mesh`'s shapes against JAX's with fake host devices in a
subprocess, as tests/test_sharding.py builds its meshes.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_arch_names as jall_arch_names
from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro import sharding as jshd
from repro_torch import sharding as shd
from repro_torch.configs import INPUT_SHAPES, get_config, input_specs
from repro_torch.launch import dryrun, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = jall_arch_names()
V5E = dict(model_axis=16, param_budget=8e9)  # JAX's MODEL_AXIS and PER_CHIP_PARAM_BUDGET


def _duck_mesh(layout):
    """What JAX's fit_spec / param_spec read of a mesh."""
    class DuckMesh:
        axis_names = tuple(layout)
        devices = np.empty(tuple(layout.values()))
    return DuckMesh()


def _spec(p):
    """A PartitionSpec or a port placement as a list (joint axes as lists)."""
    return [list(a) if isinstance(a, tuple) else a for a in tuple(p)]


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_matches_jax(arch):
    """fsdp_degree and the (node, fsdp, model) layout at JAX's v5e values on
    256 and 512 chips, and fsdp_degree at other device counts and model
    axes (JAX's takes the model axis as an argument too)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for total in (256, 512):
        f = jmesh.fsdp_degree(jcfg, total)
        assert mesh.fsdp_degree(cfg, total, **V5E) == f
        assert mesh.logical_layout(cfg, total, **V5E) == {
            "node": total // (f * jmesh.MODEL_AXIS), "fsdp": f, "model": jmesh.MODEL_AXIS}
    for total in (1, 8, 64):
        for model_axis in (1, 2, 16):
            assert mesh.fsdp_degree(cfg, total, model_axis=model_axis, param_budget=8e9) == \
                jmesh.fsdp_degree(jcfg, total, model_axis=model_axis)


@pytest.mark.parametrize("dims", [(4, 2, 8), (2, 1, 16), (1, 4, 4), (2, 2, 1)])
def test_fit_spec_matches_jax(dims):
    """Random rules over random shapes: dropped axes, fallbacks, padding to
    rank, an axis used once."""
    layout = dict(zip(("node", "fsdp", "model"), dims))
    rng = np.random.default_rng(sum(dims))
    names = ("node", "fsdp", "model", None, ("model", "fsdp"), ("fsdp",))
    for _ in range(200):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice([1, 3, 4, 8, 16, 24, 64], rank))
        axes = tuple(names[i] for i in rng.integers(0, len(names), int(rng.integers(0, 4))))
        assert _spec(shd.fit_spec(axes, shape, layout)) == \
            _spec(jshd.fit_spec(axes, shape, _duck_mesh(layout))), (axes, shape)


def _jax_param_leaves(arch):
    shapes = jax.eval_shape(lambda: __import__("repro.models.model", fromlist=["x"]).init_params(
        jax.random.PRNGKey(0), jget_config(arch)))
    return [(jshd._path_str(p), leaf.shape)
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_jax_every_leaf(arch):
    """Every parameter leaf at the single- and multi-pod production layouts,
    stacked over the node axis and not; with and without a rule override."""
    leaves = _jax_param_leaves(arch)
    cfg = get_config(arch)
    for total in (256, 512):
        layout = mesh.logical_layout(cfg, total, **V5E)
        duck = _duck_mesh(layout)
        for overrides in ({}, {"embed": ("model", None), "mamba/in_proj": ("fsdp", None)}):
            shd.RULE_OVERRIDES.clear()
            shd.RULE_OVERRIDES.update(overrides)
            jshd.RULE_OVERRIDES.clear()
            jshd.RULE_OVERRIDES.update(overrides)
            try:
                for path, shape in leaves:
                    for stacked in (False, True):
                        full = (layout["node"],) + tuple(shape) if stacked else tuple(shape)
                        assert _spec(shd.param_spec(path, full, layout, stacked)) == \
                            _spec(jshd.param_spec(path, full, duck, stacked)), (path, stacked)
            finally:
                shd.RULE_OVERRIDES.clear()
                jshd.RULE_OVERRIDES.clear()
    # the port's own tree yields the same paths in JAX's order
    got = []
    shd._map_with_path(lambda p, leaf: got.append((p, tuple(leaf.shape))),
                       dryrun.abstract_params(cfg))
    assert sorted(got) == sorted((p, tuple(s)) for p, s in leaves)


SUBPROCESS = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro import sharding as shd
    from repro.configs import get_config
    from repro.configs.shapes import INPUT_SHAPES, input_specs
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_logical_mesh, make_production_mesh, mesh_axis_kwargs
    from repro.models.model import init_params

    arch = sys.argv[1]
    cfg = get_config(arch)

    def specs(tree):
        return [[list(a) if isinstance(a, tuple) else a for a in tuple(s.spec)]
                for s in jax.tree_util.tree_leaves(tree)]

    def shard_bytes(shapes, shardings):
        return int(sum(int(np.prod(sh.shard_shape(x.shape))) * x.dtype.itemsize for x, sh in
                       zip(jax.tree_util.tree_leaves(shapes), jax.tree_util.tree_leaves(shardings))))

    out = {"logical": {kind: list(make_logical_mesh(
               cfg, multi_pod=kind == "multi",
               production=make_production_mesh(multi_pod=kind == "multi")).devices.shape)
           for kind in ("single", "multi")},
           "probe_depths": list(dr.probe_depths(cfg)),
           "variants": json.loads(json.dumps(dr.VARIANTS)),
           "layouts": {}}
    devs = np.asarray(jax.devices()[:8])
    params = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(0), cfg))
    for dims in ((2, 2, 2), (4, 1, 2), (1, 2, 4), (8, 1, 1)):
        m = Mesh(devs.reshape(dims), ("node", "fsdp", "model"), **mesh_axis_kwargs(3))
        state = dr.train_state_specs(cfg, dims[0])
        train = input_specs(cfg, INPUT_SHAPES["train_4k"], m_nodes=dims[0])
        prefill = input_specs(cfg, INPUT_SHAPES["prefill_32k"])
        decode = input_specs(cfg, INPUT_SHAPES["decode_32k"])
        st = shd.state_shardings(state, m)
        p_sh = shd.params_shardings(params, m, node_stacked=False)
        c_sh = shd.cache_shardings(decode["cache"], m)
        out["layouts"][str(dims)] = {
            "params": specs(p_sh), "state_params": specs(st.params), "sigma": specs(st.sigma),
            "batch_train": specs(shd.batch_shardings(train, m, node_stacked=True)),
            "batch_prefill": specs(shd.batch_shardings(prefill, m, node_stacked=False)),
            "token": specs(shd.batch_shardings(decode["token"], m, node_stacked=False)),
            "cache": specs(c_sh),
            "bytes": {"params": shard_bytes(params, p_sh),
                      "state_params": shard_bytes(state.params, st.params),
                      "cache": shard_bytes(decode["cache"], c_sh)}}
    print("RESULT" + json.dumps(out))
    """
)


def _in_jax_order(tree, placements, out):
    """Placements listed in JAX's leaf order (dict keys sorted), walked by
    the tensor tree's structure."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _in_jax_order(tree[k], placements[k], out)
    elif isinstance(tree, (list, tuple)):
        for t, p in zip(tree, placements):
            _in_jax_order(t, p, out)
    else:
        out.append(_spec(placements))
    return out


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-1.2b", "deepseek-v2-lite-16b",
                                  "internvl2-2b"])
def test_tree_shardings_match_jax_in_subprocess(arch):
    """JAX's tree functions on real meshes of 8 fake host devices (and
    make_logical_mesh on 256 / 512), against the port's placements on the
    same layouts: parameters, the node-stacked state, train / prefill /
    decode inputs and the decode cache (whose k / v / state rules meet
    ".k"-style paths and do not fire, in both); per-device bytes against
    JAX's shard shapes; the dry run's probe depths and variants (JAX's
    all, plus the port's own "kernels" variant, which sets the kernel
    flags the card's serving paths run)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", SUBPROCESS, arch], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    want = json.loads([ln for ln in res.stdout.splitlines() if ln.startswith("RESULT")][0][6:])
    cfg = get_config(arch)
    for kind, total in (("single", 256), ("multi", 512)):
        lay = mesh.logical_layout(cfg, total, **V5E)
        assert [lay["node"], lay["fsdp"], lay["model"]] == want["logical"][kind]
    assert list(dryrun.probe_depths(cfg)) == want["probe_depths"]
    variants = json.loads(json.dumps(dryrun.VARIANTS))
    assert variants.pop("kernels") == {"use_flash": True, "use_ssd_kernel": True}
    assert variants == want["variants"]
    params = dryrun.abstract_params(cfg)
    for dims, w in want["layouts"].items():
        layout = dict(zip(("node", "fsdp", "model"), json.loads(dims.replace("(", "[")
                                                                 .replace(")", "]"))))
        state = dryrun.train_state_specs(cfg, layout["node"])
        train = input_specs(cfg, INPUT_SHAPES["train_4k"], m_nodes=layout["node"])
        prefill = input_specs(cfg, INPUT_SHAPES["prefill_32k"])
        decode = input_specs(cfg, INPUT_SHAPES["decode_32k"])
        st = shd.state_shardings(state, layout)
        p_sh = shd.params_shardings(params, layout, node_stacked=False)
        c_sh = shd.cache_shardings(decode["cache"], layout)
        got = {
            "params": _in_jax_order(params, p_sh, []),
            "state_params": _in_jax_order(state.params, st.params, []),
            "sigma": [_spec(st.sigma)],
            "batch_train": _in_jax_order(
                train, shd.batch_shardings(train, layout, node_stacked=True), []),
            "batch_prefill": _in_jax_order(
                prefill, shd.batch_shardings(prefill, layout, node_stacked=False), []),
            "token": [_spec(shd.batch_shardings(decode["token"], layout, node_stacked=False))],
            "cache": _in_jax_order(decode["cache"], c_sh, []),
        }
        for key, val in got.items():
            assert val == w[key], (dims, key)
        assert shd.per_device_bytes(params, p_sh, layout) == w["bytes"]["params"], dims
        assert shd.per_device_bytes(state.params, st.params, layout) == \
            w["bytes"]["state_params"], dims
        assert shd.per_device_bytes(decode["cache"], c_sh, layout) == w["bytes"]["cache"], dims


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-lite-16b"])
def test_pieces_roundtrip_and_match_per_device_bytes(arch):
    """A node-stacked smoke state cut into the 8 pieces of a 4 × 1 × 2 layout
    (and of 2 × 2 × 2, where dims are placed over fsdp and model) and put
    back together is the identity, and every rank's pieces hold what
    `per_device_bytes` says a device holds."""
    from repro_torch.core.pame import PaMEState
    from repro_torch.models.model import init_params
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch, "smoke")
    gen = torch.Generator().manual_seed(0)
    params = tree_map(lambda x: torch.randn((4,) + tuple(x.shape), generator=gen).to(x.dtype),
                      init_params(0, cfg, device="cpu"))
    state = PaMEState(params=params, sigma=torch.arange(4.0), step=3, key=5)
    for layout in ({"node": 4, "fsdp": 1, "model": 2}, {"node": 2, "fsdp": 2, "model": 2}):
        place = shd.state_shardings(state, layout)
        pieces = [shd.shard_tree(state, place, layout, shd.rank_coords(r, layout))
                  for r in range(8)]
        back = shd.assemble(pieces, place, layout)
        assert back.step == 3 and back.key == 5
        for a, b in zip(tree_leaves(back), tree_leaves(state)):
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b)
        want = (shd.per_device_bytes(state.params, place.params, layout)
                + shd.per_device_bytes(state.sigma, place.sigma, layout))
        for piece in pieces:
            got = sum(x.numel() * x.element_size() for x in tree_leaves(piece)
                      if isinstance(x, torch.Tensor))
            assert got == want
        placed = [s for s in shd.leaf_specs(state.params, place.params) if s[0] == "node"]
        assert placed and any(any(e is not None for e in s[1:]) for s in placed)


def test_rank_coords_are_row_major():
    layout = {"node": 4, "fsdp": 1, "model": 2}
    assert [tuple(shd.rank_coords(r, layout).values()) for r in range(8)] == [
        (n, 0, t) for n in range(4) for t in range(2)]
    # a dim over two axes jointly: the first axis named is the major one
    x = torch.arange(8.0)
    lay = {"node": 2, "fsdp": 2, "model": 1}
    got = [shd.cut(x, (("node", "fsdp"),), lay, shd.rank_coords(r, lay)).tolist()
           for r in range(4)]
    assert got == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]


def test_meshes_over_a_fake_process_group():
    """`make_logical_mesh` lays the group's ranks out as (node, fsdp, model)
    from an explicit layout or from `logical_layout` of a config, and
    `make_production_mesh` is the flat mesh of every rank (torch's fake
    process group of 8 ranks stands in for 8 cards)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=8)
    try:
        lay = {"node": 4, "fsdp": 1, "model": 2}
        m = mesh.make_logical_mesh(device_type="cpu", layout=lay)
        assert m.mesh_dim_names == ("node", "fsdp", "model")
        assert shd.mesh_layout(m) == lay and shd.mesh_coords(m) == shd.rank_coords(3, lay)
        cfg = get_config("qwen3-14b")
        m2 = mesh.make_logical_mesh(cfg, device_type="cpu", param_budget=4e10)
        assert shd.mesh_layout(m2) == mesh.logical_layout(cfg, 8, model_axis=1,
                                                          param_budget=4e10)
        assert shd.mesh_layout(m2)["fsdp"] > 1
        flat = mesh.make_production_mesh(device_type="cpu")
        assert flat.mesh_dim_names == ("data",) and flat.size() == 8
        with pytest.raises(ValueError, match="does not cover"):
            mesh.make_logical_mesh(device_type="cpu", layout={"node": 2, "fsdp": 1, "model": 2})
    finally:
        dist.destroy_process_group()
