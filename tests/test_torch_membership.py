"""Elastic membership and the chaos timeline in the port
(`repro_torch.serve.membership`) against the JAX package
(`tests/test_membership.py` and `tests/test_chaos.py`'s cases).

The topology half is numpy: grown and shrunk graphs, their
Metropolis–Hastings weights and the donors are bit-equal to JAX's.  The
state half: `expand_state` bit-equal to JAX's, `retire_state` bit-equal in
f32 and in bf16 (the same dtype chain: the mean summed in f32 in node
order and cast to the leaf's type, the deviation in the leaf's type,
β·deviation in f32 cast to it, the sum in it).  Mean preservation is held
at atol 1e-5 in f32, as in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.topology import build_topology as jbuild
from repro.serve import membership as jmb
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core.faults import FaultModel
from repro_torch.core.pame import make_topology_arrays
from repro_torch.core.scenarios import (
    PartitionWindow,
    Scenario,
    make_scenario_arrays,
    realization_matrix,
    realize,
)
from repro_torch.core.topology import build_topology
from repro_torch.serve import membership as mb

from _torch_parity import to_np, to_t

M_OLD = 8


def _grown(n_new=4, degree=2, seed=0):
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    return topo, mb.grown_topology(topo, n_new, degree=degree, seed=seed)


def _grad_fn(p, b, k):
    ab, yb = b
    r = ab @ p - yb
    return 0.5 * torch.mean(r * r), ab.T @ r / r.shape[0]


def _batch(m, seed):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((m, 4, 5)).astype(np.float32)),
            torch.as_tensor(rng.standard_normal((m, 4)).astype(np.float32)))


def _trained_state(steps=6):
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    bound = TALG.get_algorithm("pame").bind(_grad_fn, topo, TALG.PaMEHp(nu=0.5, p=0.5),
                                            device="cpu")
    batch = _batch(M_OLD, 0)
    state, _ = bound.run(1, torch.zeros(5), M_OLD, lambda k: batch, steps)
    return state


# ---------------------------------------------------------------------------
# topology growth and shrinkage
# ---------------------------------------------------------------------------
def test_grown_mixing_doubly_stochastic():
    _, g = _grown()
    assert g.m == M_OLD + 4
    np.testing.assert_allclose(g.mixing.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(g.mixing.sum(axis=0), 1.0, atol=1e-12)
    assert np.array_equal(g.mixing, g.mixing.T)


def test_grown_preserves_old_graph_and_mean():
    topo, g = _grown()
    assert np.array_equal(g.adjacency[:M_OLD, :M_OLD], topo.adjacency)
    x = np.random.default_rng(0).standard_normal((g.m, 7))
    np.testing.assert_allclose((g.mixing @ x).mean(axis=0), x.mean(axis=0), atol=1e-12)


def test_realized_matrix_across_join_doubly_stochastic():
    _, g = _grown()
    scen = Scenario(name="harsh", edge_drop=0.2, straggler=0.3, seed=1)
    arrays = make_scenario_arrays(g, scen)
    for k in range(5):
        w = realization_matrix(arrays, realize(scen, arrays, k)).numpy().astype(np.float64)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-5)
        x = np.random.default_rng(k).standard_normal((g.m, 3))
        np.testing.assert_allclose((w @ x).mean(axis=0), x.mean(axis=0), atol=1e-5)


def test_new_nodes_attach_to_old_nodes_only():
    _, g = _grown(n_new=4, degree=3)
    for i in range(M_OLD, g.m):
        assert all(j < M_OLD for j in g.neighbor_sets[i])
        assert len(g.neighbor_sets[i]) == 3


def test_zero_join_topology_is_same_object():
    topo = build_topology("ring", M_OLD)
    assert mb.grown_topology(topo, 0) is topo


def test_kappa_stable_for_incumbent_nodes():
    topo, g = _grown()
    cfg = TALG.PaMEHp(kappa_lo=3, kappa_hi=7)
    old = make_topology_arrays(topo, cfg, seed=5, device="cpu").kappa
    new = make_topology_arrays(g, cfg, seed=5, device="cpu").kappa
    assert torch.equal(new[:M_OLD], old)


def test_join_spec_parsing():
    evs = mb.parse_join_spec("40:2,20:1:3", degree=2)
    assert evs == (mb.JoinEvent(20, 1, 3), mb.JoinEvent(40, 2, 2))
    assert mb.parse_join_spec(None) == () and mb.parse_join_spec("") == ()
    with pytest.raises(ValueError):
        mb.parse_join_spec("40")
    with pytest.raises(ValueError):
        mb.JoinEvent(step=1, n_new=1, degree=0)


def test_topology_from_adjacency_validates():
    a = np.zeros((3, 3), np.int64)
    a[0, 1] = 1  # asymmetric
    with pytest.raises(ValueError):
        mb.topology_from_adjacency(a)
    a = np.eye(3, dtype=np.int64)
    with pytest.raises(ValueError, match="zero diagonal"):
        mb.topology_from_adjacency(a)


def test_shrunk_mixing_doubly_stochastic():
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    s = mb.shrunk_topology(topo, (6, 7))
    assert s.m == M_OLD - 2
    np.testing.assert_allclose(s.mixing.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(s.mixing.sum(axis=0), 1.0, atol=1e-12)
    assert np.array_equal(s.mixing, s.mixing.T)
    assert np.array_equal(s.adjacency, topo.adjacency[:6, :6])


def test_shrunk_topology_validates():
    topo = build_topology("ring", 4)
    assert mb.shrunk_topology(topo, ()) is topo
    with pytest.raises(ValueError):
        mb.shrunk_topology(topo, (4,))
    with pytest.raises(ValueError, match="at least one must remain"):
        mb.shrunk_topology(topo, (0, 1, 2, 3))


@pytest.mark.parametrize("kind", ["ring", "erdos_renyi", "regular"])
@pytest.mark.parametrize("n_new,seed", [(1, 0), (2, 3), (4, 5)])
def test_grow_shrink_round_trip(kind, n_new, seed):
    """Growing by n and retiring the n newest nodes gives back the graph and
    its weights: joins and LIFO departures are inverse operations."""
    topo = build_topology(kind, M_OLD, p=0.5, seed=seed)
    grown = mb.grown_topology(topo, n_new, degree=2, seed=seed)
    back = mb.shrunk_topology(grown, tuple(range(M_OLD, M_OLD + n_new)))
    assert back.m == topo.m
    np.testing.assert_array_equal(back.adjacency, topo.adjacency)
    np.testing.assert_allclose(back.mixing, topo.mixing, atol=1e-12)


@pytest.mark.parametrize("kind,n_new,degree,seed", [
    ("erdos_renyi", 4, 2, 0), ("ring", 2, 3, 7), ("regular", 3, 1, 2), ("complete", 1, 2, 5)])
def test_grown_shrunk_topologies_and_donors_equal_jax(kind, n_new, degree, seed):
    """Grown and shrunk graphs, their weights, spectral gaps and the donors:
    bit-equal to JAX's (numpy on both sides, the same draws)."""
    kw = {"p": 0.5, "seed": 3}
    tj, tt = jbuild(kind, M_OLD, **kw), build_topology(kind, M_OLD, **kw)
    gj = jmb.grown_topology(tj, n_new, degree=degree, seed=seed)
    gt = mb.grown_topology(tt, n_new, degree=degree, seed=seed)
    sj = jmb.shrunk_topology(gj, (1, gj.m - 1))
    st = mb.shrunk_topology(gt, (1, gt.m - 1))
    for a, b in ((gj, gt), (sj, st)):
        assert a.m == b.m and a.neighbor_sets == b.neighbor_sets
        np.testing.assert_array_equal(a.adjacency, b.adjacency)
        np.testing.assert_array_equal(a.mixing, b.mixing)
        assert a.zeta == b.zeta
    np.testing.assert_array_equal(mb.default_donors(gt, M_OLD), jmb.default_donors(gj, M_OLD))


# ---------------------------------------------------------------------------
# state expansion
# ---------------------------------------------------------------------------
def test_expand_state_zero_joins_bitwise_noop():
    state = _trained_state()
    assert mb.expand_state(state, M_OLD, []) is state


def test_expand_state_clones_donors():
    state = _trained_state()
    donors = np.array([2, 0, 5])
    grown = mb.expand_state(state, M_OLD, donors)
    assert grown.params.shape[0] == M_OLD + 3
    assert torch.equal(grown.params[:M_OLD], state.params)
    assert torch.equal(grown.params[M_OLD:], state.params[torch.as_tensor(donors)])
    assert torch.equal(grown.sigma[M_OLD:], state.sigma[torch.as_tensor(donors)])
    assert grown.step == state.step and grown.key == state.key


def test_expand_state_validates_donors():
    state = _trained_state()
    with pytest.raises(ValueError):
        mb.expand_state(state, M_OLD, [M_OLD])


def test_expand_state_equals_jax():
    """A node-stacked tree (f32, bf16, int32 rows, a scalar and an unstacked
    leaf) grown with the same donors: bitwise JAX's."""
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((M_OLD, 3, 5)).astype(np.float32),
            "h": jnp.asarray(rng.standard_normal((M_OLD, 7)), jnp.bfloat16),
            "i": rng.integers(0, 9, (M_OLD, 2)).astype(np.int32),
            "s": np.float32(3.0), "u": rng.standard_normal(3).astype(np.float32)}
    src = {k: (v + 1 if k in ("w", "i") else v) for k, v in tree.items()}
    donors = np.array([5, 1, 1])
    for source in (None, src):
        want = jmb.expand_state(jax.tree_util.tree_map(jnp.asarray, tree), M_OLD, donors,
                                None if source is None else
                                jax.tree_util.tree_map(jnp.asarray, source))
        got = mb.expand_state({k: to_t(v) for k, v in tree.items()}, M_OLD, donors,
                              None if source is None else {k: to_t(v) for k, v in source.items()})
        for k in tree:
            assert got[k].dtype == to_t(np.asarray(want[k])).dtype, k
            g = to_np(got[k])
            np.testing.assert_array_equal(g, np.asarray(want[k]).astype(g.dtype), err_msg=k)


def test_checkpoint_catchup_equals_live_for_frozen_state(tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint

    state = _trained_state()
    save_checkpoint(str(tmp_path), 6, {"state": state})
    restored = restore_checkpoint(str(tmp_path), {"state": state}, 6)["state"]
    donors = np.array([1, 4])
    via_live = mb.expand_state(state, M_OLD, donors)
    via_ckpt = mb.expand_state(state, M_OLD, donors, source_state=restored)
    assert torch.equal(via_live.params, via_ckpt.params)
    assert torch.equal(via_live.sigma, via_ckpt.sigma)
    assert via_live.step == via_ckpt.step and via_live.key == via_ckpt.key


def test_grown_state_trains_under_grown_topology():
    state = _trained_state()
    _, g = _grown()
    grown = mb.expand_state(state, M_OLD, mb.default_donors(g, M_OLD))
    bound = TALG.get_algorithm("pame").bind(_grad_fn, g, TALG.PaMEHp(nu=0.5, p=0.5),
                                            device="cpu")
    batch = _batch(g.m, 1)
    new_state, hist = TB.run_algorithm(bound.step, grown, lambda k: batch, 5,
                                       params_of=bound.params_of)
    assert np.all(np.isfinite(hist["loss"]))
    assert bound.params_of(new_state).shape[0] == g.m


# ---------------------------------------------------------------------------
# graceful departures
# ---------------------------------------------------------------------------
def test_retire_state_mean_preserving():
    state = _trained_state()
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    pre_p = state.params.double().mean(dim=0)
    pre_s = state.sigma.double().mean(dim=0)
    out = mb.retire_state(state, topo, (6, 7))
    assert out.params.shape[0] == M_OLD - 2
    torch.testing.assert_close(out.params.double().mean(dim=0), pre_p, rtol=0, atol=1e-5)
    torch.testing.assert_close(out.sigma.double().mean(dim=0), pre_s, rtol=0, atol=1e-5)
    assert out.step == state.step


def test_retire_state_zero_leavers_bitwise_noop():
    state = _trained_state()
    assert mb.retire_state(state, build_topology("ring", M_OLD), ()) is state


def test_retire_consensus_state_costs_nothing():
    state = _trained_state()
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    consensus = state._replace(params=state.params[:1].expand_as(state.params).clone(),
                               sigma=state.sigma[:1].expand_as(state.sigma).clone())
    out = mb.retire_state(consensus, topo, (7,))
    torch.testing.assert_close(out.params, consensus.params[:7], atol=1e-6, rtol=1e-6)


def test_retire_then_train_stays_finite():
    state = _trained_state()
    topo = build_topology("erdos_renyi", M_OLD, p=0.5, seed=3)
    shrunk = mb.retire_state(state, topo, (6, 7))
    s_topo = mb.shrunk_topology(topo, (6, 7))
    bound = TALG.get_algorithm("pame").bind(_grad_fn, s_topo, TALG.PaMEHp(nu=0.5, p=0.5),
                                            device="cpu")
    batch = _batch(s_topo.m, 2)
    new_state, hist = TB.run_algorithm(bound.step, shrunk, lambda k: batch, 5,
                                       params_of=bound.params_of)
    assert np.all(np.isfinite(hist["loss"]))
    assert bound.params_of(new_state).shape[0] == s_topo.m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("leavers", [(4,), (1, 4), (0,)])
def test_retire_state_equals_jax(dtype, leavers):
    """A 5-node stack of 4096 values near 0.02 (the bf16 case of the leave
    check) plus a 2-D f32 leaf and an int32 leaf, retired against the same
    graph: bitwise JAX's."""
    rng = np.random.default_rng(11)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tree = {"p": jnp.asarray(0.02 + 0.01 * rng.standard_normal((5, 4096)), jdt),
            "q": jnp.asarray(rng.standard_normal((5, 3, 4)), jnp.float32),
            "k": jnp.asarray(rng.integers(0, 99, (5, 2)), jnp.int32),
            "s": jnp.asarray(7, jnp.int32)}
    topo_j, topo_t = jbuild("erdos_renyi", 5, p=0.6, seed=2), build_topology(
        "erdos_renyi", 5, p=0.6, seed=2)
    want = jmb.retire_state(tree, topo_j, leavers)
    got = mb.retire_state({k: to_t(v) for k, v in tree.items()}, topo_t, leavers)
    for k in tree:
        w = np.asarray(want[k])
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16),
                                          err_msg=k)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


def test_retire_state_blocks_of_columns(monkeypatch):
    """The column blocks do not change a value: a leaf retired a few columns
    at a time equals the one-block result bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((5, 3, 7)).astype(np.float32)).to(torch.bfloat16)
    topo = build_topology("complete", 5)
    whole = mb.retire_state({"x": x}, topo, (3,))["x"]
    monkeypatch.setattr(mb, "BLOCK_COLS", 4)
    assert torch.equal(mb.retire_state({"x": x}, topo, (3,))["x"], whole)


# ---------------------------------------------------------------------------
# fault / membership separation and the chaos timeline
# ---------------------------------------------------------------------------
def test_crash_faults_refused_with_joins():
    with pytest.raises(ValueError, match="fixed-m"):
        mb.check_join_faults(FaultModel(name="c", crash=0.02, rejoin=0.2))


def test_non_crash_faults_allowed_with_joins():
    mb.check_join_faults(None)
    mb.check_join_faults(FaultModel(name="l", loss=0.2))


def test_crash_faults_refused_with_leaves():
    with pytest.raises(ValueError, match="crash"):
        mb.check_membership_faults(FaultModel(name="c", crash=0.02, rejoin=0.2),
                                   (mb.ChaosEvent(step=5, kind="leave", n=1),))


def test_leave_join_same_step_refused():
    evs = (mb.ChaosEvent(step=5, kind="leave", n=1), mb.ChaosEvent(step=5, kind="join", n=1))
    with pytest.raises(ValueError, match="same step"):
        mb.check_membership_faults(None, evs)


def test_membership_change_inside_partition_window_refused():
    evs = (mb.ChaosEvent(step=4, kind="partition", n=2), mb.ChaosEvent(step=6, kind="leave", n=1),
           mb.ChaosEvent(step=8, kind="heal"))
    with pytest.raises(ValueError, match="partition window"):
        mb.check_membership_faults(None, evs)
    ok = (mb.ChaosEvent(step=4, kind="partition", n=2), mb.ChaosEvent(step=8, kind="heal"),
          mb.ChaosEvent(step=9, kind="leave", n=1))
    mb.check_membership_faults(None, ok, m0=8)


def test_timeline_emptying_graph_refused():
    evs = (mb.ChaosEvent(step=2, kind="leave", n=3), mb.ChaosEvent(step=4, kind="leave", n=1))
    with pytest.raises(ValueError, match="retire"):
        mb.check_membership_faults(None, evs, m0=4)
    mb.check_membership_faults(None, evs[:1], m0=4)


def test_partition_wider_than_remaining_graph_refused():
    evs = (mb.ChaosEvent(step=2, kind="leave", n=2), mb.ChaosEvent(step=4, kind="partition", n=4))
    with pytest.raises(ValueError, match="3 nodes remain"):
        mb.check_membership_faults(None, evs, m0=5)


def test_loss_faults_allowed_with_timeline():
    mb.check_membership_faults(FaultModel(name="l", loss=0.2),
                               (mb.ChaosEvent(step=5, kind="leave", n=1),), m0=8)


def test_parse_chaos_spec_grammar():
    spec = "leave@200:2,partition@400:bridge,heal@800,join@900:1"
    evs = mb.parse_chaos_spec(spec, degree=3)
    assert evs == (
        mb.ChaosEvent(step=200, kind="leave", n=2),
        mb.ChaosEvent(step=400, kind="partition", n=2),
        mb.ChaosEvent(step=800, kind="heal"),
        mb.ChaosEvent(step=900, kind="join", n=1, degree=3),
    )
    assert [(e.step, e.kind, e.n, e.degree) for e in evs] == [
        (e.step, e.kind, e.n, e.degree) for e in jmb.parse_chaos_spec(spec, degree=3)]
    assert mb.parse_chaos_spec("partition@10:3")[0].n == 3
    assert mb.parse_chaos_spec("join@5:2:4")[0].degree == 4
    assert mb.parse_chaos_spec(None) == () and mb.parse_chaos_spec("") == ()


def test_parse_chaos_spec_rejects_malformed():
    for bad in ("leave@10", "heal@10:1", "partition@10", "reboot@10:1", "leave:10:1"):
        with pytest.raises(ValueError):
            mb.parse_chaos_spec(bad)
    with pytest.raises(ValueError):
        mb.ChaosEvent(step=1, kind="partition", n=1)


def test_chaos_partitions_folds_windows():
    spec = "partition@4:bridge,heal@8,partition@12:3"
    windows = mb.chaos_partitions(mb.parse_chaos_spec(spec), num_steps=20, seed=7)
    assert windows == (PartitionWindow(start=4, heal=8, n_parts=2, seed=7),
                       PartitionWindow(start=12, heal=20, n_parts=3, seed=7))
    jw = jmb.chaos_partitions(jmb.parse_chaos_spec(spec), num_steps=20, seed=7)
    assert [(w.start, w.heal, w.n_parts, w.seed) for w in windows] == [
        (w.start, w.heal, w.n_parts, w.seed) for w in jw]
    assert mb.chaos_partitions(mb.parse_chaos_spec("leave@4:1"), 20) == ()


def test_chaos_partitions_rejects_bad_pairing():
    with pytest.raises(ValueError, match="still open"):
        mb.chaos_partitions(mb.parse_chaos_spec("partition@4:2,partition@6:2"), 20)
    with pytest.raises(ValueError, match="without an open"):
        mb.chaos_partitions(mb.parse_chaos_spec("heal@4"), 20)


# ---------------------------------------------------------------------------
# partition schedules (tests/test_chaos.py's realization cases, on the port)
# ---------------------------------------------------------------------------
def _topo8(seed=3):
    return build_topology("erdos_renyi", M_OLD, p=0.5, seed=seed)


def test_scenario_rejects_overlapping_windows():
    with pytest.raises(ValueError):
        Scenario(name="x", partitions=(PartitionWindow(start=2, heal=10),
                                       PartitionWindow(start=6, heal=12)))
    scen = Scenario(name="x", partitions=(PartitionWindow(start=2, heal=4),))
    assert not scen.is_static and scen.max_parts == 2


def test_partition_components_connected_cover():
    from repro_torch.core.scenarios import partition_components

    topo = _topo8()
    comp = partition_components(topo, PartitionWindow(start=0, heal=1, n_parts=3, seed=1))
    assert comp.shape == (M_OLD,) and set(np.unique(comp)) == {0, 1, 2}
    for c in range(3):
        nodes = np.nonzero(comp == c)[0]
        sub = topo.adjacency[np.ix_(nodes, nodes)]
        reach, frontier = {0}, [0]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(sub[i])[0]:
                if j not in reach:
                    reach.add(int(j))
                    frontier.append(int(j))
        assert len(reach) == len(nodes)


def test_partition_components_explicit_validated():
    from repro_torch.core.scenarios import partition_components

    topo = _topo8()
    w = PartitionWindow(start=0, heal=1, components=((0, 1, 2, 3), (4, 5, 6, 7)))
    np.testing.assert_array_equal(partition_components(topo, w), [0, 0, 0, 0, 1, 1, 1, 1])
    with pytest.raises(ValueError):
        partition_components(topo, PartitionWindow(start=0, heal=1,
                                                   components=((0, 1, 2, 3), (4, 5, 6))))


def test_partition_realization_block_doubly_stochastic():
    from repro_torch.core.scenarios import partition_components

    topo = _topo8()
    scen = Scenario(name="split", edge_drop=0.2, seed=1,
                    partitions=(PartitionWindow(start=3, heal=7, seed=2),))
    arrays = make_scenario_arrays(topo, scen)
    comp = partition_components(topo, scen.partitions[0])
    cross = comp[:, None] != comp[None, :]
    for k in range(10):
        w = realization_matrix(arrays, realize(scen, arrays, k)).numpy().astype(np.float64)
        np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-5)
        if 3 <= k < 7:
            assert w[cross].sum() == 0.0
            x = np.random.default_rng(k).standard_normal((M_OLD, 3))
            for c in np.unique(comp):
                sel = comp == c
                np.testing.assert_allclose((w @ x)[sel].mean(axis=0), x[sel].mean(axis=0),
                                           atol=1e-5)


def test_heal_restores_base_matrix():
    from repro_torch.core.scenarios import partition_components

    topo = _topo8()
    scen = Scenario(name="split-only", seed=1, partitions=(PartitionWindow(start=2, heal=5,
                                                                           seed=2),))
    arrays = make_scenario_arrays(topo, scen)
    comp = partition_components(topo, scen.partitions[0])
    cross = comp[:, None] != comp[None, :]
    for k in (0, 1, 5, 6):
        w = realization_matrix(arrays, realize(scen, arrays, k)).numpy()
        np.testing.assert_allclose(w, topo.mixing, atol=1e-6)
    for k in (2, 3, 4):
        w = realization_matrix(arrays, realize(scen, arrays, k)).numpy()
        assert w[cross].sum() == 0.0 and not np.allclose(w, topo.mixing, atol=1e-6)


def test_active_components_window_gating():
    from repro_torch.core.scenarios import active_components, partition_components

    topo = _topo8()
    scen = Scenario(name="split-only", seed=1, partitions=(PartitionWindow(start=2, heal=5,
                                                                           seed=2),))
    arrays = make_scenario_arrays(topo, scen)
    comp = partition_components(topo, scen.partitions[0])
    np.testing.assert_array_equal(active_components(arrays, 1).numpy(), np.zeros(M_OLD))
    np.testing.assert_array_equal(active_components(arrays, 3).numpy(), comp)
    np.testing.assert_array_equal(active_components(arrays, 5).numpy(), np.zeros(M_OLD))


def test_component_stats_hand_built():
    from repro_torch.core.scenarios import component_stats

    comp = torch.as_tensor([0, 0, 1, 1], dtype=torch.int32)
    x = torch.as_tensor([[0.0], [2.0], [10.0], [14.0]])
    cc, gap = component_stats(comp, x, 2)
    assert float(cc) == pytest.approx(2.5) and float(gap) == pytest.approx(5.5)


def test_partition_metrics_in_history():
    """The component mean gap grows inside the window and reconverges after
    the heal (PaME's memoryless averaging heals the drift)."""
    scen = Scenario(name="split-only", seed=1, partitions=(PartitionWindow(start=10, heal=20,
                                                                           seed=2),))
    bound = TALG.get_algorithm("pame").bind(_grad_fn, _topo8(), TALG.PaMEHp(nu=0.5, p=0.5),
                                            scenario=scen, device="cpu")
    batch = _batch(M_OLD, 0)
    _, hist = bound.run(1, torch.zeros(5), M_OLD, lambda k: batch, 40)
    assert len(hist["comp_consensus"]) == 40
    gap = np.asarray(hist["comp_mean_gap"])
    assert gap[10:20].max() > 10 * max(gap[:10].max(), 1e-12)
    assert gap[-1] < 0.1 * gap[10:20].max()
