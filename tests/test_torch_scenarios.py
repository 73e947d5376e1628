"""Dynamic-network scenarios of the port (`repro_torch.core.scenarios`)
against the JAX package (`repro.core.scenarios`), with JAX's uniforms
injected: masks, realizations, the realized matrix, the three scenario
mixer modes, `freeze_dropped`, partition windows and component stats;
bound steps of all six algorithms under an i.i.d. scenario on the
regression fixture and on the 1-layer smoke LM; the port's own samplers
held statistically; the static reduction bit for bit; and the invariants
of tests/test_invariants.py under scenarios.

Tolerances: f32, rtol 1e-5 and atol 1e-6 unless a case states another;
masks, partition maps and the static reduction bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as JS
from repro_torch import convert
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core import scenarios as TS
from repro_torch.core.topology import build_topology as tbuild

from _torch_parity import (ALL, A_NP, JB, M, N, TB_, W0_NP, Y_NP, _pair, binds, bound_parity,
                           check_fixed_point, hps, inv_batch, inv_hps, inv_params,
                           jax_scenario_draws, lm_setup, lm_binds, t_grad, to_np, zero_grad)

GRAPHS = [("ring", 6, {}), ("grid", 9, {}), ("erdos_renyi", 8, {"p": 0.5, "seed": 3}),
          ("star", 5, {})]
HARSH = dict(edge_drop=0.25, churn=0.15, straggler=0.2, seed=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Hundreds of tiny torch ops a step: one intra-op thread, as in
    tests/test_torch_baselines.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# specs, masks and realizations
# ---------------------------------------------------------------------------
def test_presets_and_validation_match_jax():
    assert TS.list_scenarios() == JS.list_scenarios()
    for name in JS.list_scenarios():
        assert dataclasses.asdict(TS.get_scenario(name)) == dataclasses.asdict(
            JS.get_scenario(name))
        assert TS.get_scenario(name).is_static == JS.get_scenario(name).is_static
    for bad in (dict(edge_drop=1.5), dict(churn=-0.1)):
        with pytest.raises(ValueError):
            TS.Scenario(**bad)
    with pytest.raises(ValueError, match="overlap"):
        TS.Scenario(partitions=(TS.PartitionWindow(0, 5), TS.PartitionWindow(3, 8)))
    with pytest.raises(ValueError):
        TS.PartitionWindow(4, 4)
    with pytest.raises(ValueError, match="unknown scenario"):
        TS.get_scenario("nope")
    w = TS.PartitionWindow(2, 6, components=((0, 1), (2, 3, 4)))
    assert w.n_parts == 2 and TS.Scenario(partitions=(w,)).max_parts == 2


@pytest.mark.parametrize("kind,m,kw", GRAPHS)
def test_partition_components_bitwise(kind, m, kw):
    tj, tt = _pair(kind, m, kw)
    for win in (dict(start=1, heal=4, n_parts=2, seed=7), dict(start=0, heal=2, n_parts=3)):
        np.testing.assert_array_equal(
            TS.partition_components(tt, TS.PartitionWindow(**win)),
            JS.partition_components(tj, JS.PartitionWindow(**win)))
    comps = (tuple(range(m // 2)), tuple(range(m // 2, m)))
    np.testing.assert_array_equal(
        TS.partition_components(tt, TS.PartitionWindow(0, 1, components=comps)),
        JS.partition_components(tj, JS.PartitionWindow(0, 1, components=comps)))


def _symmetric_edge_up(arrays_t, rng, p=0.3):
    """A random edge mask that agrees on both directions of every link."""
    m = arrays_t.m
    up = rng.random((m, m)) >= p
    up = np.triu(up, 1)
    up = up | up.T
    nbrs = arrays_t.nbrs.numpy()
    return up[np.arange(m)[:, None], nbrs]


@pytest.mark.parametrize("kind,m,kw", GRAPHS)
def test_realization_from_masks_matches_jax(kind, m, kw):
    tj, tt = _pair(kind, m, kw)
    aj, at = JS.make_scenario_arrays(tj, JS.Scenario()), TS.make_scenario_arrays(tt, TS.Scenario())
    np.testing.assert_array_equal(at.nbrs_full.numpy(), np.asarray(aj.nbrs_full))
    rng = np.random.default_rng(0)
    for _ in range(5):
        edge_up = _symmetric_edge_up(at, rng)
        alive, strag = rng.random(m) > 0.2, rng.random(m) < 0.2
        rj = JS.realization_from_masks(aj, jnp.asarray(edge_up), jnp.asarray(alive),
                                       jnp.asarray(strag))
        rt = TS.realization_from_masks(at, torch.as_tensor(edge_up), torch.as_tensor(alive),
                                       torch.as_tensor(strag))
        for f in ("edge_alive", "alive", "participating"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
        assert int(rt.directed_edges) == int(rj.directed_edges)
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(TS.realization_matrix(at, rt).numpy(),
                                   np.asarray(JS.realization_matrix(aj, rj)), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("kind,m,kw", GRAPHS)
def test_realize_with_jax_uniforms_matches_jax(kind, m, kw):
    """`sample_masks` / `realize` on the uniforms JAX draws: the masks bit
    for bit, the weights to f32 rounding."""
    tj, tt = _pair(kind, m, kw)
    sj, st = JS.Scenario(**HARSH), TS.Scenario(**HARSH)
    aj, at = JS.make_scenario_arrays(tj, sj), TS.make_scenario_arrays(tt, st)
    for k in range(6):
        u = jax_scenario_draws(aj, k)
        for got, want in zip(TS.sample_masks(st, at, k, u=u),
                             JS.sample_masks(sj, aj, jnp.asarray(k))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        rt, rj = TS.realize(st, at, k, u=u), JS.realize(sj, aj, jnp.asarray(k))
        np.testing.assert_array_equal(rt.edge_alive.numpy(), np.asarray(rj.edge_alive))
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights), rtol=1e-6,
                                   atol=1e-7)


def test_partition_cut_masks_and_components_bitwise():
    """Partition windows carry no randomness: the cut masks and component
    maps are JAX's bit for bit, inside and outside the windows."""
    tj, tt = _pair("ring", 8, {})
    wins = ((2, 4, 2, None, 1), (5, 7, None, ((0, 1, 2), (3, 4), (5, 6, 7)), 0))
    jw = tuple(JS.PartitionWindow(s, h, n or 2, c, sd) for s, h, n, c, sd in wins)
    tw = tuple(TS.PartitionWindow(s, h, n or 2, c, sd) for s, h, n, c, sd in wins)
    sj, st = JS.Scenario(partitions=jw), TS.Scenario(partitions=tw)
    aj, at = JS.make_scenario_arrays(tj, sj), TS.make_scenario_arrays(tt, st)
    assert st.max_parts == sj.max_parts == 3 and not st.is_static
    for k in range(9):
        for got, want in zip(TS.sample_masks(st, at, k), JS.sample_masks(sj, aj, jnp.asarray(k))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(TS.active_components(at, k).numpy(),
                                      np.asarray(JS.active_components(aj, jnp.asarray(k))))


@pytest.mark.parametrize("mode", ["sparse", "dense", "matrix"])
def test_scenario_mixer_modes_match_jax(mode):
    """Each mixer mode on one realization, every `Mixer` operation, against
    JAX's scenario mixer of the same mode."""
    tj, tt = _pair("erdos_renyi", 8, {"p": 0.5, "seed": 3})
    sj, st = JS.Scenario(**HARSH), TS.Scenario(**HARSH)
    aj, at = JS.make_scenario_arrays(tj, sj), TS.make_scenario_arrays(tt, st)
    u = jax_scenario_draws(aj, 2)
    rj, rt = JS.realize(sj, aj, jnp.asarray(2)), TS.realize(st, at, 2, u=u)
    mj = JS.scenario_mixer(aj, rj, mode, impl="slots" if mode != "matrix" else None)
    mt = TS.scenario_mixer(at, rt, mode, impl="slots" if mode != "matrix" else None)
    rng = np.random.default_rng(1)
    x, h = rng.standard_normal((8, 5, 3)).astype(np.float32), rng.standard_normal((8, 5, 3)).astype(np.float32)
    for op in ("mix", "mix_lazy", "mix_half"):
        np.testing.assert_allclose(to_np(getattr(mt, op)(torch.as_tensor(x))),
                                   np.asarray(getattr(mj, op)(jnp.asarray(x))), rtol=1e-5,
                                   atol=1e-6, err_msg=op)
    np.testing.assert_allclose(
        to_np(mt.mix_nids_quantized(torch.as_tensor(h), torch.as_tensor(x))),
        np.asarray(mj.mix_nids_quantized(jnp.asarray(h), jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_sparse_and_dense_scenario_mixers_agree():
    tt = tbuild("grid", 9)
    st = TS.Scenario(**HARSH)
    at = TS.make_scenario_arrays(tt, st)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((9, 7)).astype(np.float32))
    for k in range(4):
        r = TS.realize(st, at, k)
        sparse = TS.scenario_mixer(at, r, "sparse", impl="slots").mix(x)
        dense = TS.scenario_mixer(at, r, "dense", impl="slots").mix(x)
        torch.testing.assert_close(sparse, dense, rtol=1e-5, atol=1e-6)


def test_freeze_dropped_matches_jax_bitwise():
    rng = np.random.default_rng(3)
    old = {"w": rng.standard_normal((6, 4)).astype(np.float32),
           "s": rng.standard_normal(6).astype(np.float32),
           "n": np.arange(6, dtype=np.int32)}
    new = {k: (v + 1).astype(v.dtype) for k, v in old.items()}
    alive = np.array([1, 0, 1, 1, 0, 1], bool)
    want = JS.freeze_dropped(jnp.asarray(alive), jax.tree_util.tree_map(jnp.asarray, old),
                             jax.tree_util.tree_map(jnp.asarray, new))
    got = TS.freeze_dropped(torch.as_tensor(alive), convert.to_torch(old),
                            convert.to_torch(new))
    for k in old:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    rows = TS.dropped_rows(torch.as_tensor(alive), convert.to_torch(old))
    assert sorted((i, tuple(r.shape)) for _, i, r in rows) == [(1, ()), (1, (4,)), (4, ()),
                                                               (4, (4,))]


def test_component_stats_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 10)).astype(np.float32)
    comp = np.array([0, 0, 1, 1, 1, 2, 2, 0], np.int32)
    want = JS.component_stats(jnp.asarray(comp), jnp.asarray(x), 4)
    got = TS.component_stats(torch.as_tensor(comp), torch.as_tensor(x), 4)
    leafwise = TS.component_stats(torch.as_tensor(comp),
                                  [torch.as_tensor(x[:, :3]), torch.as_tensor(x[:, 3:])], 4)
    for g, lw, w in zip(got, leafwise, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(lw), float(w), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the port's own samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,m,kw", GRAPHS)
def test_port_realizations_doubly_stochastic(kind, m, kw):
    st = TS.Scenario(**HARSH)
    at = TS.make_scenario_arrays(tbuild(kind, m, **kw), st)
    for k in range(20):
        r = TS.realize(st, at, k)
        b = TS.realization_matrix(at, r).double()
        torch.testing.assert_close(b, b.T, rtol=0, atol=0)
        torch.testing.assert_close(b.sum(0), torch.ones(m, dtype=torch.float64), atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(b.sum(1), torch.ones(m, dtype=torch.float64), atol=1e-6,
                                   rtol=0)
        for i in torch.nonzero(~r.participating).flatten().tolist():
            assert float(b[i, i]) == 1.0


def test_edge_uniform_one_draw_per_undirected_link():
    """Both directions of a link read the same uniform, so the realized
    adjacency is symmetric; over many steps the link failure rate is the
    scenario's edge_drop."""
    tt = tbuild("erdos_renyi", 10, p=0.5, seed=1)
    nbrs, valid = (torch.as_tensor(v) for v in tt.neighbor_matrix_padded())
    u = TS.edge_uniform(123, nbrs)
    for i in range(10):
        for s in range(nbrs.shape[1]):
            if valid[i, s]:
                j = int(nbrs[i, s])
                back = int(torch.nonzero(nbrs[j] == i)[0])
                assert float(u[i, s]) == float(u[j, back])
    st = TS.Scenario(edge_drop=0.3, seed=2)
    at = TS.make_scenario_arrays(tt, st)
    down = [(~TS.sample_masks(st, at, k)[0])[at.valid].float().mean() for k in range(400)]
    assert abs(float(torch.stack(down).mean()) - 0.3) < 0.03


def test_zero_rate_draws_are_skipped():
    """Adding churn never changes the edge draws, and a zero rate draws
    nothing (its injected uniforms are ignored)."""
    tt = tbuild("ring", 6)
    base, churny = TS.Scenario(edge_drop=0.4, seed=5), TS.Scenario(edge_drop=0.4, churn=0.3, seed=5)
    ab, ac = TS.make_scenario_arrays(tt, base), TS.make_scenario_arrays(tt, churny)
    for k in range(10):
        assert torch.equal(TS.sample_masks(base, ab, k)[0], TS.sample_masks(churny, ac, k)[0])
    u = {"node": torch.zeros(6), "strag": torch.zeros(6), "edge": torch.zeros(6, 2)}
    edge_up, alive, strag = TS.sample_masks(TS.Scenario(), ab, 0, u=u)
    assert edge_up.all() and alive.all() and not strag.any()
    occ = torch.stack([~TS.sample_masks(churny, ac, k)[1] for k in range(500)]).float().mean()
    assert abs(float(occ) - 0.3) < 0.03


def test_expected_matrix_doubly_stochastic():
    tt = tbuild("complete", 5)
    e = TS.expected_matrix(tt, TS.get_scenario("dynamic_er"), num_samples=64)
    np.testing.assert_allclose(e.sum(0), 1.0, atol=1e-6)
    np.testing.assert_allclose(e.sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(e, e.T, atol=1e-7)


# ---------------------------------------------------------------------------
# bound steps against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_bound_dynamic_steps_match_jax(name):
    """Four steps under an i.i.d. scenario with link failures, churn and
    stragglers: every state tree and every realized metric."""
    bj, bt = binds(name, {"scenario": JS.Scenario(**HARSH)}, {"scenario": TS.Scenario(**HARSH)})
    assert bt.dynamic and not bt.carries_aux
    out = bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 4)
    assert {"wire_bits", "alive_nodes"} <= set(out[0][1])
    assert min(float(mt["alive_nodes"]) for _, mt in out) < M  # churn happened


@pytest.mark.parametrize("name", ["pame", "dpsgd"])
def test_bound_dynamic_dense_mixing_matches_jax(name):
    bj, bt = binds(name, {"scenario": JS.Scenario(**HARSH)}, {"scenario": TS.Scenario(**HARSH)},
                   mixing="dense")
    bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 3)


def test_partition_metrics_match_jax():
    """comp_consensus and comp_mean_gap through a window and after its heal."""
    wj = (JS.PartitionWindow(1, 3, n_parts=2, seed=2),)
    wt = (TS.PartitionWindow(1, 3, n_parts=2, seed=2),)
    bj, bt = binds("dpsgd", {"scenario": JS.Scenario(edge_drop=0.1, partitions=wj)},
                   {"scenario": TS.Scenario(edge_drop=0.1, partitions=wt)})
    out = bound_parity("dpsgd", bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 4)
    assert all("comp_mean_gap" in mt for _, mt in out)


@pytest.mark.parametrize("name", ["pame", "dpsgd"])
def test_static_scenario_bit_identical_to_fixed_topology(name):
    """A static scenario binds the fixed-topology program: same steps,
    same states, bit for bit."""
    topo = tbuild("erdos_renyi", M, p=0.6, seed=1)
    spec = TALG.get_algorithm(name)
    plain = spec.bind(t_grad, topo, hps(TALG, name), device="cpu")
    static = spec.bind(t_grad, topo, hps(TALG, name), device="cpu",
                       scenario=TS.get_scenario("static"))
    assert not static.dynamic
    _, hp = plain.run(0, torch.zeros(N), M, lambda k: TB_(), 5, tol_std=0.0)
    sp, _ = plain.run(0, torch.zeros(N), M, lambda k: TB_(), 5, tol_std=0.0)
    ss, hs = static.run(0, torch.zeros(N), M, lambda k: TB_(), 5, tol_std=0.0)
    assert hp["loss"] == hs["loss"]
    assert torch.equal(plain.params_of(sp), static.params_of(ss))


def test_dropped_nodes_frozen_bitwise_stragglers_update_locally():
    """Under churn 1.0 nobody moves; under straggler 1.0 every node takes
    only its local step (self-loop weight 1)."""
    topo = tbuild("ring", 6)
    w0 = torch.as_tensor(np.random.default_rng(5).standard_normal((6, 4)).astype(np.float32))
    batch = (torch.as_tensor(A_NP[:6, :, :4]), torch.as_tensor(Y_NP[:6]))
    for scen, frozen in ((TS.Scenario(churn=1.0), True), (TS.Scenario(straggler=1.0), False)):
        bound = TALG.get_algorithm("dpsgd").bind(t_grad, topo, TALG.DPSGDHp(lr=0.1),
                                                 device="cpu", scenario=scen)
        st = bound.init(0, w0.clone())
        st, met = bound.step(st, batch, 0)
        if frozen:
            assert torch.equal(st.params, w0) and int(met["alive_nodes"]) == 0
            assert float(met["wire_bits"]) == 0.0
        else:
            local = torch.stack([w0[i] - 0.1 * t_grad(w0[i], (batch[0][i], batch[1][i]), 0)[1]
                                 for i in range(6)])
            torch.testing.assert_close(st.params, local, rtol=0, atol=1e-6)


def test_realized_wire_bits_hand_count():
    """D-PSGD pays edge_bits on every realized directed edge."""
    st = TS.Scenario(**HARSH)
    bound = TALG.get_algorithm("dpsgd").bind(t_grad, tbuild("grid", 9), TALG.DPSGDHp(),
                                             device="cpu", scenario=st)
    state = bound.init(0, TB.stack_params(torch.zeros(N), 9))
    batch = (torch.as_tensor(A_NP[:1].repeat(9, 0)), torch.as_tensor(Y_NP[:1].repeat(9, 0)))
    for k in range(4):
        r = TS.realize(st, bound.scen_arrays, k)
        state, met = bound.step(state, batch, k)
        assert float(met["wire_bits"]) == float(
            np.float32(int(r.directed_edges)) * np.float32(TALG._full_msg_bits(None, N)))


def test_dynamic_run_host_equals_scan():
    bound = TALG.get_algorithm("choco").bind(t_grad, tbuild("erdos_renyi", M, p=0.6, seed=1),
                                             hps(TALG, "choco"), device="cpu",
                                             scenario=TS.Scenario(**HARSH))
    outs = {d: bound.run(0, torch.zeros(N), M, lambda k: TB_(), 7, tol_std=0.0, driver=d,
                         chunk_size=3) for d in ("scan", "host")}
    (ss, hs), (sh, hh) = outs["scan"], outs["host"]
    assert hs["loss"] == hh["loss"] and hs["wire_bits"] == hh["wire_bits"]
    assert hs["alive_nodes"] == hh["alive_nodes"] and len(hs["wire_bits"]) == 7
    assert hs["wire_bits_total"] == pytest.approx(sum(hs["wire_bits"]))
    torch.testing.assert_close(ss.params, sh.params, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the smoke LM (1 layer, f32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm():
    return lm_setup()


@pytest.mark.parametrize("name", ["pame", "dpsgd"])
def test_dynamic_lm_steps_match_jax(name, lm):
    """Three steps on the LM under an i.i.d. scenario, to 1e-4 (the LM's
    forward / backward in another framework, as tests/test_torch_train.py)."""
    bj, bt, sj, stt, bjx, btx = lm_binds(name, lm, {"scenario": JS.Scenario(**HARSH)},
                                         {"scenario": TS.Scenario(**HARSH)})
    bound_parity(name, bj, bt, sj, stt, bjx, btx, 3, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# invariants (tests/test_invariants.py) under a dynamic scenario
# ---------------------------------------------------------------------------
INV_SCEN = dict(churn=0.3, edge_drop=0.3, straggler=0.3, seed=2)


@pytest.mark.parametrize("name", ALL)
def test_zero_grad_consensus_fixed_point_dynamic(name):
    """Identical parameters and zero gradients under churn, link failures
    and stragglers: the global mean stays at the initial point, and every
    node stays there for the memory-free three (PaME, D-PSGD, DFedSAM)."""
    bound = TALG.get_algorithm(name).bind(zero_grad, tbuild("erdos_renyi", M, p=0.5, seed=0),
                                          inv_hps(name), device="cpu",
                                          scenario=TS.Scenario(**INV_SCEN))
    params0 = inv_params()
    state, hist = bound.run(0, params0, M, lambda k: inv_batch(), 4, tol_std=0.0,
                            chunk_size=2)
    check_fixed_point(name, bound, state, params0, ("pame", "dpsgd", "dfedsam"))
    assert len(hist["wire_bits"]) == 4
    assert all(b >= 0.0 and np.isfinite(b) for b in hist["wire_bits"])


@pytest.mark.parametrize("name,dynamic", [(n, d) for n in ALL[1:] for d in (False, True)])
def test_zero_grad_heterogeneous_mean_preserved(name, dynamic):
    """Zero-gradient steps of the doubly stochastic gossip algorithms keep
    the per-leaf global mean from heterogeneous parameters, static and
    dynamic."""
    scen = TS.Scenario(**INV_SCEN) if dynamic else None
    bound = TALG.get_algorithm(name).bind(zero_grad, tbuild("erdos_renyi", M, p=0.5, seed=1),
                                          inv_hps(name), device="cpu", scenario=scen)
    rng = np.random.default_rng(3)
    stacked = {"w": torch.as_tensor(rng.standard_normal((M, 4, 3)).astype(np.float32)),
               "b": torch.as_tensor(rng.standard_normal((M, 5)).astype(np.float32))}
    means = {k: v.mean(dim=0).clone() for k, v in stacked.items()}
    state = bound.init(1, stacked, inv_batch())
    for k in range(2):
        state, _ = bound.step(state, inv_batch(), k) if bound.dynamic else bound.step(
            state, inv_batch())
    atol = 1e-4 if name == "anq_nids" else 1e-5
    for key, leaf in bound.params_of(state).items():
        torch.testing.assert_close(leaf.mean(dim=0), means[key], rtol=0, atol=atol)
