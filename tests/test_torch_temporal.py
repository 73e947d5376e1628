"""Temporal dynamics of the port (`repro_torch.core.temporal`) against the
JAX package (`repro.core.temporal`), with JAX's uniforms injected: the
stationary initial draws, `advance` over several steps of each preset
(Gilbert–Elliott bursts, sessions, mobility epochs, i.i.d. and Markov
stragglers, bounded staleness), the snapshot ring; bound steps of all six
algorithms with staleness on the regression fixture and on the smoke LM;
the degenerate-Markov and staleness-0 reductions bit for bit; the port's
own chains held statistically; the invariants of tests/test_invariants.py
under staleness; and the in-place delayed-row substitution against JAX's
`ring_gather` form.

Tolerances: f32, rtol 1e-5 and atol 1e-6 unless a case states another;
masks, chain states, delays and the reductions bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mixing as jmix
from repro.core import scenarios as JS
from repro.core import temporal as JT
from repro_torch import convert
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core import mixing as tmix
from repro_torch.core import scenarios as TS
from repro_torch.core import temporal as TT
from repro_torch.core.topology import build_topology as tbuild

from _torch_parity import (ALL, JB, M, N, TB_, W0_NP, _pair, binds, bound_parity,
                           check_fixed_point, hps, inv_batch, inv_hps, inv_params,
                           jax_temporal_draws, jax_temporal_init_draws, lm_binds, lm_setup,
                           t_grad, zero_grad)

STALE = dict(burst_down=0.1, burst_up=0.4, leave=0.1, rejoin=0.4, straggler=0.4, staleness=2,
             seed=5)
PRESETS = ("bursty_links", "sessions", "mobile", "stale_stragglers", "straggle_sessions",
           "markov_harsh")


@pytest.fixture(scope="module")
def lm():
    return lm_setup()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_presets_and_validation_match_jax():
    assert TT.list_temporal_scenarios() == JT.list_temporal_scenarios()
    for name in PRESETS:
        t, j = TT.get_temporal_scenario(name), JT.get_temporal_scenario(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("is_static", "mobile", "stationary_bad", "stationary_down",
                     "stationary_late", "mean_burst_len", "mean_session_len"):
            assert getattr(t, prop) == getattr(j, prop), (name, prop)
    for bad in (dict(burst_down=0.1, burst_up=0.0), dict(leave=0.2, rejoin=0.0),
                dict(straggle_on=0.1, straggle_off=0.0), dict(straggler=0.1, straggle_on=0.1),
                dict(staleness=-1), dict(resample_every=-2), dict(mobility_keep=1.5)):
        with pytest.raises(ValueError):
            TT.TemporalScenario(**bad)
    with pytest.raises(ValueError, match="unknown temporal"):
        TT.get_temporal_scenario("nope")


def _spec(name):
    j = JT.get_temporal_scenario(name)
    return dataclasses.replace(j, seed=3), TT.TemporalScenario(**{
        **dataclasses.asdict(j), "seed": 3})


@pytest.mark.parametrize("name", PRESETS)
def test_advance_matches_jax_over_steps(name):
    """The stationary initial draw and 30 transitions of each preset, on
    JAX's uniforms: chain states, ages, delays and masks bit for bit,
    weights to f32 rounding."""
    sj, st = _spec(name)
    tj, tt = _pair("erdos_renyi", 8, {"p": 0.5, "seed": 2})
    aj, at = JS.make_scenario_arrays(tj, sj), TS.make_scenario_arrays(tt, st)
    jts = JT.temporal_state_init(sj, aj)
    tts = TT.temporal_state_init(st, at, u=jax_temporal_init_draws(aj))
    for f in jts._fields:
        np.testing.assert_array_equal(getattr(tts, f).numpy(), np.asarray(getattr(jts, f)))
    for k in range(30):
        kk = 3 * k if name == "mobile" else k  # cross mobility epochs
        jts, rj, dj, tauj = JT.advance(sj, aj, jts, jnp.asarray(kk))
        tts, rt, dt, taut = TT.advance(st, at, tts, kk, u=jax_temporal_draws(sj, aj, kk))
        for f in jts._fields:
            np.testing.assert_array_equal(getattr(tts, f).numpy(), np.asarray(getattr(jts, f)),
                                          err_msg=f"{name} step {k} {f}")
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(taut.numpy(), np.asarray(tauj))
        for f in ("edge_alive", "alive", "participating"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights), rtol=1e-6,
                                   atol=1e-7)


def test_ring_push_and_gather_match_jax():
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jring = JT.ring_init(jax.tree_util.tree_map(jnp.asarray, params), 3)
    tring = TT.ring_init(convert.to_torch(params), 3)
    assert JT.ring_init(params, 0) is None and TT.ring_init(convert.to_torch(params), 0) is None
    for k in range(4):
        new = jax.tree_util.tree_map(lambda x: (x + k + 1).astype(np.float32), params)
        jring = JT.ring_push(jring, jax.tree_util.tree_map(jnp.asarray, new), jnp.asarray(k), 3)
        tring = TT.ring_push(tring, convert.to_torch(new), k, 3)
    for key in params:
        np.testing.assert_array_equal(tring[key].numpy(), np.asarray(jring[key]))
    slot, use = np.array([0, 2, 1, 1, 0], np.int32), np.array([1, 0, 1, 1, 0], bool)
    fresh = {"w": np.zeros((5, 3), np.float32), "b": np.zeros(5, np.float32)}
    want = jmix.ring_gather(jring, jax.tree_util.tree_map(jnp.asarray, fresh),
                            jnp.asarray(slot), jnp.asarray(use))
    got = tmix.ring_gather(tring, convert.to_torch(fresh), torch.as_tensor(slot),
                           torch.as_tensor(use))
    for key in params:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ---------------------------------------------------------------------------
# reductions, bit for bit (port against port)
# ---------------------------------------------------------------------------
def test_degenerate_markov_matches_iid_bitwise():
    """burst_up = 1 − burst_down and rejoin = 1 − leave forget the chain
    state: the same streams give the i.i.d. scenario's realizations."""
    tt = tbuild("erdos_renyi", 8, p=0.5, seed=2)
    iid = TS.Scenario(edge_drop=0.3, churn=0.2, straggler=0.25, seed=6)
    mk = TT.TemporalScenario(burst_down=0.3, burst_up=0.7, leave=0.2, rejoin=0.8,
                             straggler=0.25, seed=6)
    ai, am = TS.make_scenario_arrays(tt, iid), TS.make_scenario_arrays(tt, mk)
    ts = TT.temporal_state_init(mk, am)
    for k in range(25):
        ts, rm, delayed, _ = TT.advance(mk, am, ts, k)
        ri = TS.realize(iid, ai, k)
        assert not delayed.any()
        for f in rm._fields:
            assert torch.equal(getattr(rm, f), getattr(ri, f)), (k, f)


def test_straggler_sessions_degenerate_to_iid_bitwise():
    tt = tbuild("ring", 6)
    iid = TT.TemporalScenario(straggler=0.3, seed=1)
    sess = TT.TemporalScenario(straggle_on=0.3, straggle_off=0.7, seed=1)
    ai, asess = TS.make_scenario_arrays(tt, iid), TS.make_scenario_arrays(tt, sess)
    ti, tse = TT.temporal_state_init(iid, ai), TT.temporal_state_init(sess, asess)
    for k in range(25):
        ti, ri, _, _ = TT.advance(iid, ai, ti, k)
        tse, rs, _, _ = TT.advance(sess, asess, tse, k)
        assert torch.equal(ri.participating, rs.participating)
        assert torch.equal(ri.weights, rs.weights)


@pytest.mark.parametrize("name", ["dpsgd", "pame", "choco"])
def test_staleness_zero_bit_identical_to_iid_straggler_path(name):
    """A temporal scenario with i.i.d. stragglers and staleness 0 excludes
    them exactly as the i.i.d. scenario does: the same states bit for bit."""
    topo = tbuild("erdos_renyi", M, p=0.6, seed=1)
    spec = TALG.get_algorithm(name)
    bi = spec.bind(t_grad, topo, hps(TALG, name), device="cpu",
                   scenario=TS.Scenario(straggler=0.4, seed=2))
    bt = spec.bind(t_grad, topo, hps(TALG, name), device="cpu",
                   scenario=TT.TemporalScenario(straggler=0.4, staleness=0, seed=2))
    si = bi.init(0, TB.stack_params(torch.as_tensor(W0_NP[0]), M))
    st = bt.init(0, TB.stack_params(torch.as_tensor(W0_NP[0]), M))
    aux = bt.aux_init(st)
    assert aux.ring is None
    for k in range(5):
        si, mi = bi.step(si, TB_(), k)
        st, mt, aux = bt.step(st, TB_(), k, aux)
        assert torch.equal(bi.params_of(si), bt.params_of(st))
        assert float(mi["loss_mean"]) == float(mt["loss_mean"])


# ---------------------------------------------------------------------------
# the port's own chains
# ---------------------------------------------------------------------------
def _occupancy(scen, steps=600, m=10):
    tt = tbuild("erdos_renyi", m, p=0.5, seed=4)
    arrays = TS.make_scenario_arrays(tt, scen)
    ts = TT.temporal_state_init(scen, arrays)
    edge, node, late, stay = [], [], [], []
    for k in range(steps):
        prev = ts.edge_bad
        ts, _, _, _ = TT.advance(scen, arrays, ts, k)
        edge.append(ts.edge_bad[arrays.valid].float().mean())
        node.append(ts.node_down.float().mean())
        late.append(ts.late.float().mean())
        if prev[arrays.valid].any():
            stay.append((ts.edge_bad & prev)[arrays.valid].sum() / prev[arrays.valid].sum())
    mean = lambda xs: float(torch.stack(xs).float().mean()) if xs else 0.0  # noqa: E731
    return mean(edge), mean(node), mean(late), mean(stay), arrays


def test_gilbert_elliott_stationary_occupancy_and_symmetry():
    """Bad-link occupancy at the stationary law from step 0, bursts that
    persist with probability 1 − burst_up, and one chain per undirected
    link (the bad mask is symmetric)."""
    scen = TT.TemporalScenario(burst_down=0.1, burst_up=0.3, seed=3)
    edge, _, _, stay, arrays = _occupancy(scen)
    assert abs(edge - scen.stationary_bad) < 0.03
    assert abs(stay - (1.0 - scen.burst_up)) < 0.05
    ts, _, _, _ = TT.advance(scen, arrays, TT.temporal_state_init(scen, arrays), 0)
    nbrs = arrays.nbrs
    for i in range(arrays.m):
        for s in range(nbrs.shape[1]):
            if arrays.valid[i, s]:
                j = int(nbrs[i, s])
                back = int(torch.nonzero(nbrs[j] == i)[0])
                assert bool(ts.edge_bad[i, s]) == bool(ts.edge_bad[j, back])


def test_session_and_straggler_session_occupancy():
    _, node, _, _, _ = _occupancy(TT.TemporalScenario(leave=0.05, rejoin=0.2, seed=1))
    assert abs(node - 0.2) < 0.04
    scen = TT.TemporalScenario(straggle_on=0.1, straggle_off=0.25, seed=2)
    _, _, late, _, _ = _occupancy(scen)
    assert abs(late - scen.stationary_late) < 0.04


def test_mobility_epochs_hold_their_edges():
    scen = TT.TemporalScenario(resample_every=5, mobility_keep=0.5, seed=7)
    arrays = TS.make_scenario_arrays(tbuild("complete", 6), scen)
    ts = TT.temporal_state_init(scen, arrays)
    alive = []
    for k in range(15):
        ts, r, _, _ = TT.advance(scen, arrays, ts, k)
        alive.append(r.edge_alive)
    for e in range(3):
        for k in range(5 * e + 1, 5 * e + 5):
            assert torch.equal(alive[k], alive[5 * e])
    assert not torch.equal(alive[0], alive[5])


def test_realizations_doubly_stochastic_delayed_participate():
    scen = TT.TemporalScenario(**STALE)
    arrays = TS.make_scenario_arrays(tbuild("grid", 9), scen)
    ts = TT.temporal_state_init(scen, arrays)
    seen = 0
    for k in range(40):
        ts, r, delayed, tau = TT.advance(scen, arrays, ts, k)
        b = TS.realization_matrix(arrays, r).double()
        torch.testing.assert_close(b.sum(0), torch.ones(9, dtype=torch.float64), atol=1e-6,
                                   rtol=0)
        assert (r.participating[delayed]).all() and (tau[delayed] >= 1).all()
        assert (tau[delayed] <= scen.staleness).all() and (tau[~delayed] == 0).all()
        seen += int(delayed.sum())
    assert seen > 0


# ---------------------------------------------------------------------------
# bound steps against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_bound_temporal_steps_match_jax(name):
    """Six steps under Markov bursts, sessions and i.i.d. stragglers with
    staleness 2 (delayed nodes mixed from the ring): every state tree and
    every metric, stale_hist included."""
    bj, bt = binds(name, {"scenario": JT.TemporalScenario(**STALE)},
                   {"scenario": TT.TemporalScenario(**STALE)})
    assert bt.temporal and bt.carries_aux
    out = bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 6)
    assert sum(float(mt["stale_nodes"]) for _, mt in out) > 0


@pytest.mark.parametrize("name", ["pame", "dpsgd"])
def test_temporal_lm_steps_match_jax(name, lm):
    """Three steps on the smoke LM with staleness 2, to 1e-4."""
    bj, bt, sj, stt, bjx, btx = lm_binds(name, lm, {"scenario": JT.TemporalScenario(**STALE)},
                                         {"scenario": TT.TemporalScenario(**STALE)})
    bound_parity(name, bj, bt, sj, stt, bjx, btx, 3, rtol=1e-4, atol=1e-4)


def test_substitution_moves_only_delayed_rows_and_matches_ring_gather():
    """The bound step's in-place substitution equals JAX's form: the
    parameter stack becomes ring_gather(ring, fresh, (k − τ) mod D,
    delayed) (τ = D included: its snapshot sits in the slot being pushed),
    slot k mod D receives the fresh stack, and the shift rows are
    fresh − delayed for the delayed nodes only."""
    scen = TT.TemporalScenario(straggler=0.5, staleness=2, seed=1)
    bound = TALG.get_algorithm("dpsgd").bind(t_grad, tbuild("ring", 4), TALG.DPSGDHp(),
                                             device="cpu", scenario=scen)
    rng = np.random.default_rng(2)
    fresh = torch.as_tensor(rng.standard_normal((4, 3)).astype(np.float32))
    ring = torch.as_tensor(rng.standard_normal((2, 4, 3)).astype(np.float32))
    delayed = torch.tensor([True, False, True, False])
    tau = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    k = 4  # slot k mod 2 = 0 = (k − 2) mod 2: node 0 reads the slot being pushed
    want = tmix.ring_gather(ring, fresh, torch.remainder(k - tau, 2), delayed)
    state = TB.dpsgd_init(0, fresh.clone())
    ring_t = ring.clone()
    got_fresh, shift = bound._substitute_delayed(state, ring_t, k, delayed, tau, 2, True)
    assert torch.equal(state.params, want)
    assert torch.equal(ring_t[0], fresh) and torch.equal(ring_t[1], ring[1])
    assert torch.equal(got_fresh, fresh)
    assert sorted(shift.rows) == [0, 2]
    for i in (0, 2):
        assert torch.equal(shift.rows[i][0], fresh[i] - want[i])


@pytest.mark.parametrize("name", ALL)
def test_stale_mixing_preserves_invariants(name):
    """Under staleness: from identical parameters with zero gradients the
    global mean stays at the initial point (every node, for PaME, D-PSGD
    and DFedSAM), and from heterogeneous parameters the mean-preserving
    gossip algorithms keep the per-leaf global mean: the delayed copy is
    mixed consistently and each delayed node re-adds its innovation."""
    scen = TT.TemporalScenario(burst_down=0.1, burst_up=0.5, straggler=0.5, staleness=3,
                               seed=2)
    topo = tbuild("erdos_renyi", M, p=0.5, seed=0)
    bound = TALG.get_algorithm(name).bind(zero_grad, topo, inv_hps(name), device="cpu",
                                          scenario=scen)
    params0 = inv_params()
    state, hist = bound.run(0, params0, M, lambda k: inv_batch(), 5, tol_std=0.0,
                            chunk_size=2)
    check_fixed_point(name, bound, state, params0, ("pame", "dpsgd", "dfedsam"))
    assert sum(hist["staleness_hist"][1:]) > 0
    if name == "pame":
        return
    rng = np.random.default_rng(3)
    stacked = {"w": torch.as_tensor(rng.standard_normal((M, 4, 3)).astype(np.float32)),
               "b": torch.as_tensor(rng.standard_normal((M, 5)).astype(np.float32))}
    means = {kk: v.mean(dim=0).clone() for kk, v in stacked.items()}
    state = bound.init(1, stacked, inv_batch())
    aux = bound.aux_init(state)
    for k in range(4):
        state, _, aux = bound.step(state, inv_batch(), k, aux)
    atol = 1e-4 if name == "anq_nids" else 1e-5
    for kk, leaf in bound.params_of(state).items():
        torch.testing.assert_close(leaf.mean(dim=0), means[kk], rtol=0, atol=atol)


def test_temporal_host_equals_scan_and_chunk_invariance():
    bound = TALG.get_algorithm("beer").bind(t_grad, tbuild("erdos_renyi", M, p=0.6, seed=1),
                                            TALG.BeerHp(lr=0.02, gossip_gamma=0.3,
                                                        comp_frac=0.3),
                                            device="cpu",
                                            scenario=TT.TemporalScenario(**STALE))
    runs = {}
    for driver, chunk in (("scan", 3), ("scan", 7), ("host", 1)):
        runs[(driver, chunk)] = bound.run(0, torch.zeros(N), M, lambda k: TB_(), 7,
                                          tol_std=0.0, driver=driver, chunk_size=chunk)
    (s0, h0) = runs[("host", 1)]
    for key, (s, h) in runs.items():
        assert h["loss"] == h0["loss"], key
        assert h["staleness_hist"] == h0["staleness_hist"], key
        assert h["stale_nodes"] == h0["stale_nodes"], key
        torch.testing.assert_close(s.params, s0.params, rtol=0, atol=0)
    assert len(h0["staleness_hist"]) == 3 and sum(h0["staleness_hist"][1:]) > 0


def test_stop_rule_freezes_state_and_carry():
    """Under the engine's stop rule the returned state and carry are the
    triggering step's, with the ring (updated in place by the step) cloned
    per step."""
    bound = TALG.get_algorithm("dpsgd").bind(t_grad, tbuild("erdos_renyi", M, p=0.6, seed=1),
                                             TALG.DPSGDHp(lr=0.05), device="cpu",
                                             scenario=TT.TemporalScenario(**STALE))
    a_t, y_t = TB_()

    def objective(w):
        return 0.5 * torch.mean((torch.einsum("msn,n->ms", a_t, w) - y_t) ** 2)

    outs = {d: bound.run(0, torch.zeros(N), M, lambda k: TB_(), 40, objective_fn=objective,
                         tol_std=0.2, driver=d, chunk_size=16) for d in ("scan", "host")}
    (ss, hs), (sh, hh) = outs["scan"], outs["host"]
    assert 3 <= hh["steps_run"] < 40 and hs["steps_run"] == hh["steps_run"]
    torch.testing.assert_close(ss.params, sh.params, rtol=0, atol=0)
    assert ss.step == sh.step == hh["steps_run"]
