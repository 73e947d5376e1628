"""Message-level faults of the port (`repro_torch.core.faults`) against the
JAX package (`repro.core.faults`), with JAX's uniforms injected: the fault
chains and per-receiver renormalized weights over several steps,
`fault_matrix`, `mix_replicated`; bound fault steps of all six algorithms
(the replicated CHOCO, BEER and ANQ-NIDS steps included, with and without
repair) on the regression fixture and on the smoke LM; the zero-rate
reduction and the crash freeze bit for bit; the port's own chains held
statistically; and the chip smoke's parity phase E rehearsed on the CPU.

Tolerances: f32, rtol 1e-5 and atol 1e-6 unless a case states another;
masks, delivery decisions, the reduction and the freeze bit for bit."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import faults as JF
from repro.core import mixing as jmix
from repro.core import scenarios as JS
from repro_torch.configs import get_config
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core import faults as TF
from repro_torch.core import mixing as tmix
from repro_torch.core import scenarios as TS
from repro_torch.core.topology import build_topology as tbuild

from _torch_parity import (ALL, JB, M, N, TB_, W0_NP, _pair, binds, bound_parity,
                           check_fixed_point, inv_batch, inv_hps, inv_params, jax_fault_draws,
                           jax_fault_init_draws, jax_scenario_draws, lm_binds, lm_setup, t_grad,
                           to_np, zero_grad)

HARSH = dict(loss=0.2, burst_down=0.1, burst_up=0.3, crash=0.1, rejoin=0.4, delay=0.3,
             max_delay=2, seed=2)


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
    assert TF.list_fault_models() == JF.list_fault_models()
    for name in JF.list_fault_models():
        t, j = TF.get_fault_model(name), JF.get_fault_model(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.is_static == j.is_static and t.stationary_lossy == j.stationary_lossy
    for bad in (dict(loss=2.0), dict(max_delay=-1), dict(delay=0.2), dict(burst_down=0.1,
                burst_up=0.0), dict(crash=0.1, rejoin=0.0)):
        with pytest.raises(ValueError):
            TF.FaultModel(**bad)
    with pytest.raises(ValueError, match="unknown fault"):
        TF.get_fault_model("nope")


@pytest.mark.parametrize("base", [None, dict(edge_drop=0.2, churn=0.1, straggler=0.1, seed=3)])
def test_advance_faults_matches_jax_over_steps(base):
    """The stationary link draw and 25 transitions on JAX's uniforms, over a
    static and a dynamic base scenario: chain states, delivery masks,
    delays and drop counts bit for bit, renormalized weights, column
    defect and drift to f32 rounding."""
    tj, tt = _pair("erdos_renyi", 8, {"p": 0.5, "seed": 2})
    sj = JS.Scenario(**base) if base else JS.Scenario()
    st = TS.Scenario(**base) if base else TS.Scenario()
    aj, at = JS.make_scenario_arrays(tj, sj), TS.make_scenario_arrays(tt, st)
    mj, mt = JF.FaultModel(**HARSH), TF.FaultModel(**HARSH)
    key = jax.random.PRNGKey(mj.seed)
    d = aj.nbrs.shape[1]
    fj = JF.fault_state_init(mj, aj, key)
    ft = TF.fault_state_init(mt, at, mt.seed, u=jax_fault_init_draws(key, 8, d))
    np.testing.assert_array_equal(ft.link_bad.numpy(), np.asarray(fj.link_bad))
    for k in range(25):
        masks_j = JS.sample_masks(sj, aj, jnp.asarray(k))
        masks_t = TS.sample_masks(st, at, k, u=jax_scenario_draws(aj, k))
        fj, rj = JF.advance_faults(mj, aj, fj, key, jnp.asarray(k), *masks_j)
        ft, rt = TF.advance_faults(mt, at, ft, mt.seed, k, *masks_t,
                                   u=jax_fault_draws(key, k, 8, d))
        for f in ("link_bad", "crashed", "age"):
            np.testing.assert_array_equal(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)))
        for f in ("recv_ok", "delayed", "tau", "dropped"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)))
        np.testing.assert_array_equal(rt.base.edge_alive.numpy(), np.asarray(rj.base.edge_alive))
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(float(rt.col_defect), float(rj.col_defect), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(ft.drift), float(fj.drift), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(TF.fault_matrix(at, rt).numpy(),
                                   np.asarray(JF.fault_matrix(aj, rj)), rtol=1e-6, atol=1e-7)


def test_faulted_matrix_row_stochastic_column_defect_asymmetric():
    """The port's own draws: rows sum to 1, the column defect is the
    returned col_defect, the drift its running sum, and losses are drawn
    per direction (some link delivers one way only)."""
    tt = tbuild("erdos_renyi", 10, p=0.5, seed=1)
    model = TF.FaultModel(loss=0.3, seed=4)
    at = TS.make_scenario_arrays(tt, TS.Scenario())
    fs = TF.fault_state_init(model, at, model.seed)
    one_way = drift = 0.0
    for k in range(30):
        fs, fr = TF.advance_faults(model, at, fs, model.seed, k, *TS.sample_masks(
            TS.Scenario(), at, k))
        b = TF.fault_matrix(at, fr).double()
        torch.testing.assert_close(b.sum(1), torch.ones(10, dtype=torch.float64), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(float((b.sum(0) - 1).abs().sum()), float(fr.col_defect),
                                   rtol=1e-5, atol=1e-6)
        drift += float(fr.col_defect)
        np.testing.assert_allclose(float(fs.drift), drift, rtol=1e-5)
        one_way += float(((b > 0) != (b.T > 0)).sum())
    assert one_way > 0


def test_gilbert_elliott_lossy_link_occupancy_and_persistence():
    model = TF.FaultModel(burst_down=0.1, burst_up=0.3, seed=8)
    at = TS.make_scenario_arrays(tbuild("erdos_renyi", 10, p=0.5, seed=1), TS.Scenario())
    fs = TF.fault_state_init(model, at, model.seed)
    occ, stay = [], []
    for k in range(600):
        prev = fs.link_bad
        fs, _ = TF.advance_faults(model, at, fs, model.seed, k, *TS.sample_masks(
            TS.Scenario(), at, k))
        occ.append(fs.link_bad.float().mean())
        if prev.any():
            stay.append((fs.link_bad & prev).sum() / prev.sum())
    assert abs(float(torch.stack(occ).mean()) - model.stationary_lossy) < 0.03
    assert abs(float(torch.stack(stay).mean()) - (1 - model.burst_up)) < 0.05


def test_zero_rate_fault_draws_are_skipped():
    """A zero rate draws nothing: its injected uniforms are ignored."""
    at = TS.make_scenario_arrays(tbuild("ring", 6), TS.Scenario())
    model = TF.FaultModel(crash=0.5, seed=1)
    fs = TF.fault_state_init(model, at, 1, u={"link": torch.zeros(6, 2)})
    u = {"loss": torch.zeros(6, 2), "burst": torch.zeros(6, 2), "delay": torch.zeros(6),
         "crash": torch.ones(6)}
    fs, fr = TF.advance_faults(model, at, fs, 1, 0, *TS.sample_masks(TS.Scenario(), at, 0), u=u)
    assert fr.recv_ok.equal(fr.base.edge_alive) and not fr.delayed.any()
    assert not fs.crashed.any() and not fs.link_bad.any()


def test_mix_replicated_matches_jax_and_reads_the_joined_buffer():
    rng = np.random.default_rng(5)
    m, d = 5, 3
    w_off = rng.random((m, d)).astype(np.float32) * 0.3
    self_w = (1 - w_off.sum(1)).astype(np.float32)
    reps = {"a": rng.standard_normal((m, d, 4)).astype(np.float32),
            "b": rng.standard_normal((m, d)).astype(np.float32)}
    own = {"a": rng.standard_normal((m, 4)).astype(np.float32),
           "b": rng.standard_normal(m).astype(np.float32)}
    want = jmix.mix_replicated(jnp.asarray(w_off), jnp.asarray(self_w),
                               jax.tree_util.tree_map(jnp.asarray, reps),
                               jax.tree_util.tree_map(jnp.asarray, own))
    # the port's held leaves: receiver i's replicas, then its own value
    held = {k: torch.as_tensor(np.concatenate([reps[k], own[k][:, None]], axis=1))
            for k in reps}
    got = tmix.mix_replicated(torch.as_tensor(w_off), torch.as_tensor(self_w), held)
    for k in reps:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6)
    # the fault steps keep that layout as their state: JAX's fields are
    # views of the one buffer the mix reads in place
    st = TF.rep_choco_init(0, {"a": torch.zeros(m, 4)}, TS.make_scenario_arrays(
        tbuild("ring", m), TS.Scenario()))
    assert st.held["a"].shape == (m, st.pending.shape[1] + 1, 4)
    assert st.hats["a"].data_ptr() == st.held["a"][:, -1].data_ptr()
    assert st.reps["a"].data_ptr() == st.held["a"].data_ptr()
    with pytest.raises(RuntimeError):  # a strided leaf is refused, never copied
        tmix.mix_replicated(torch.as_tensor(w_off), torch.as_tensor(self_w),
                            {"a": held["a"].transpose(0, 1).contiguous().transpose(0, 1)})


def _fault_binds(name, model_kw, scen=None, **kw):
    return binds(name, {"faults": JF.FaultModel(**model_kw),
                        "scenario": None if scen is None else JS.Scenario(**scen)},
                 {"faults": TF.FaultModel(**model_kw),
                  "scenario": None if scen is None else TS.Scenario(**scen)}, **kw)


@pytest.mark.parametrize("name", ALL)
def test_bound_fault_steps_match_jax(name):
    """Six steps under loss, lossy-link bursts, crashes and delayed
    delivery over a dynamic base scenario: every state tree (replicas and
    pending flags of the replicated variants included) and every metric."""
    bj, bt = _fault_binds(name, HARSH, scen=dict(edge_drop=0.1, straggler=0.1, seed=1))
    assert bt.faulty and bt.carries_aux
    assert (bt.spec.rep_step is not None) == (bj.spec.rep_step is not None)
    out = bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 6)
    assert sum(float(mt["dropped_msgs"]) for _, mt in out) > 0
    assert sum(float(mt["stale_nodes"]) for _, mt in out) > 0


@pytest.mark.parametrize("name", ["choco", "beer", "anq_nids"])
def test_replicated_steps_without_repair_match_jax(name):
    bj, bt = _fault_binds(name, dict(loss=0.3, repair=False, seed=3))
    out = bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 4)
    assert all(float(mt["repair_bits"]) == 0.0 for _, mt in out)


@pytest.mark.parametrize("name", ["pame", "choco"])
def test_fault_lm_steps_match_jax(name, lm):
    """Three steps on the smoke LM under loss and delayed delivery, to 1e-4."""
    kw = dict(loss=0.2, delay=0.4, max_delay=2, seed=1)
    bj, bt, sj, stt, bjx, btx = lm_binds(name, lm, {"faults": JF.FaultModel(**kw)},
                                         {"faults": TF.FaultModel(**kw)})
    bound_parity(name, bj, bt, sj, stt, bjx, btx, 3, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["dpsgd", "pame", "choco"])
def test_static_fault_model_binds_to_fault_free_program(name):
    topo = tbuild("erdos_renyi", M, p=0.6, seed=1)
    from _torch_parity import hps

    spec = TALG.get_algorithm(name)
    plain = spec.bind(t_grad, topo, hps(TALG, name), device="cpu")
    zero = spec.bind(t_grad, topo, hps(TALG, name), device="cpu",
                     faults=TF.FaultModel(repair=False, seed=9))
    assert not zero.faulty and not zero.dynamic
    sp, hp = plain.run(0, torch.zeros(N), M, lambda k: TB_(), 5, tol_std=0.0)
    sz, hz = zero.run(0, torch.zeros(N), M, lambda k: TB_(), 5, tol_std=0.0)
    assert hp["loss"] == hz["loss"] and torch.equal(plain.params_of(sp), zero.params_of(sz))


@pytest.mark.parametrize("name", ["choco", "beer"])
def test_crash_freeze_bitwise_and_rejoin(name):
    """A crashed node's whole state (replicas included) stays bit for bit
    while it is down, and it moves again once it rejoins."""
    from _torch_parity import hps

    bound = TALG.get_algorithm(name).bind(t_grad, tbuild("erdos_renyi", M, p=0.6, seed=1),
                                          hps(TALG, name), device="cpu",
                                          faults=TF.FaultModel(crash=0.3, rejoin=0.3, seed=5))
    state = bound.init(0, TB.stack_params(torch.as_tensor(W0_NP[0]), M), TB_())
    aux = bound.aux_init(state)
    froze = moved = 0
    for k in range(8):
        before = [x.clone() for x in jax.tree_util.tree_leaves(tuple(state))
                  if isinstance(x, torch.Tensor) and x.is_floating_point()]
        state, met, aux = bound.step(state, TB_(), k, aux)
        after = [x for x in jax.tree_util.tree_leaves(tuple(state))
                 if isinstance(x, torch.Tensor) and x.is_floating_point()]
        for i in range(M):
            same = all(torch.equal(a[i], b[i]) for a, b in zip(after, before))
            if bool(aux.fs.crashed[i]):
                assert same, (k, i)
                froze += 1
            else:
                moved += not same
    assert froze > 0 and moved > 0


@pytest.mark.parametrize("name", ["pame", "dpsgd", "dfedsam"])
def test_identical_params_pinned_under_arbitrary_loss(name):
    """Zero gradients from identical parameters under heavy asymmetric loss:
    every node stays put (rows stay stochastic after renormalization)."""
    bound = TALG.get_algorithm(name).bind(zero_grad, tbuild("erdos_renyi", M, p=0.5, seed=0),
                                          inv_hps(name), device="cpu",
                                          faults=TF.FaultModel(loss=0.5, burst_down=0.2,
                                                               seed=3))
    params0 = inv_params()
    state, hist = bound.run(0, params0, M, lambda k: inv_batch(), 5, tol_std=0.0)
    check_fixed_point(name, bound, state, params0, (name,))
    assert sum(hist["dropped_msgs"]) > 0


def test_fault_host_equals_scan_and_chunk_invariance():
    from _torch_parity import hps

    bound = TALG.get_algorithm("anq_nids").bind(t_grad, tbuild("erdos_renyi", M, p=0.6, seed=1),
                                                hps(TALG, "anq_nids"), device="cpu",
                                                faults=TF.FaultModel(**HARSH))
    runs = {(d, c): bound.run(0, torch.zeros(N), M, lambda k: TB_(), 7, tol_std=0.0,
                              driver=d, chunk_size=c)
            for d, c in (("scan", 2), ("scan", 7), ("host", 1))}
    s0, h0 = runs[("host", 1)]
    for key, (s, h) in runs.items():
        for field in ("loss", "wire_bits", "repair_bits", "dropped_msgs", "mean_drift",
                      "crashed_nodes", "surrogate_desync", "stale_nodes"):
            assert h[field] == h0[field], (key, field)
        torch.testing.assert_close(s.params, s0.params, rtol=0, atol=0)
    assert h0["wire_bits_total"] == pytest.approx(sum(h0["wire_bits"]))


# ---------------------------------------------------------------------------
# the chip smoke's parity phase E, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_path_e_parity_rehearsal(monkeypatch, capsys):
    """`chip_smoke.path_e_parity` at a tiny bf16 size on the CPU, the
    kernel route forced (REPRO_TORCH_GOSSIP_IMPL=kernel) with its CPU
    stand-in replaced by the CUDA kernel's exact arithmetic (f32 slots
    chain, rounded once): every dynamic, temporal and fault step of D-PSGD
    and PaME, and the replicated fault steps of CHOCO, BEER and ANQ-NIDS,
    match the plain route to 0 ulps and f32 bit for bit, with one delayed
    node on the temporal and fault paths and a repaired replica on each
    replicated step.  With the dense f32
    matmul stand-in, which rounds some sums the other way, the phase fails:
    it would catch a kernel that rounds differently."""
    from repro_torch.kernels.gossip import ops as gops

    cs = _chip_smoke()
    cfg = get_config("stablelm-1.6b", "smoke").replace(dtype="bfloat16", n_layers=1)
    cpu = torch.device("cpu")
    monkeypatch.setenv("REPRO_TORCH_GOSSIP_IMPL", "kernel")

    def kernel_arithmetic(nbrs, terms, pad=None):
        clean = [(w if pad is None else torch.where(pad, torch.zeros_like(w), w), x.float())
                 for w, x in terms]
        return tuple(o.to(x.dtype) for o, (_, x) in
                     zip(tmix._gather_terms_slots(nbrs, clean), terms))

    with pytest.raises(SystemExit):
        cs.path_e_parity(cpu, cfg=cfg, batch=1, seq=8)
    assert "path E parity (dpsgd, dynamic)" in capsys.readouterr().err
    monkeypatch.setattr(gops, "gather_terms_ref", kernel_arithmetic)
    rows = cs.path_e_parity(cpu, cfg=cfg, batch=1, seq=8)
    assert set(rows) == {f"{a}-{n}" for a in ("dpsgd", "pame")
                         for n in ("dynamic", "temporal", "fault")} | {
        f"{a}-loss" for a in ("choco", "beer", "anq_nids")}
    for key, row in rows.items():
        assert row["max_bf16_ulps_floored"] == 0.0 and row["f32_bit_equal"], key
        assert row["loss_kernel"] == row["loss_plain"]
        assert row["stale_nodes"] == (1 if key.endswith(("temporal", "fault")) else 0)
    assert '"phase": "parity_e"' in capsys.readouterr().out


def test_rep_nids_step_by_step_against_jax_scan_driver():
    """Replicated ANQ-NIDS against JAX's scan driver (its scan and host
    drivers split for ANQ-NIDS: ROADMAP queue 3), step by step: JAX's
    compiled chunk of one step advances the state and the fault carry,
    the port restarts from them and takes the same step with JAX's draws
    injected; every state tree to rtol 1e-5, atol 1e-6, no coordinate
    off."""
    from repro.core import engine as jengine
    from repro_torch import convert

    kw = dict(loss=0.25, burst_down=0.1, burst_up=0.4, seed=6)
    bj, bt = _fault_binds("anq_nids", kw)
    runner = jengine.make_scan_runner(bj.step, chunk_size=1, step_takes_index=True,
                                      carries_aux=True)
    key = jax.random.PRNGKey(0)
    sj = bj.init(key, jnp.asarray(W0_NP), JB)
    aj = bj.aux_init(sj)
    st = bt.init(0, torch.as_tensor(W0_NP).clone(), TB_())
    arr, d = bj.scen_arrays, bj.scen_arrays.nbrs.shape[1]
    from _torch_parity import jax_compression_draws

    for k in range(5):
        st = type(st)(*[
            int(getattr(sj, f)) if f == "step" else st.key if f == "key"
            else convert.to_torch(jax.device_get(getattr(sj, f))) for f in st._fields])
        at = TF.FaultCarry(TF.FaultState(*[convert.to_torch(jax.device_get(x)) for x in aj.fs]),
                           None)
        draws = {"scenario": jax_scenario_draws(arr, k),
                 "faults": jax_fault_draws(bj.fault_key, k, arr.m, d),
                 "algo": jax_compression_draws("anq_nids", key, k, sj.params)}
        sj, _, info = runner(sj, lambda _: JB, 1, k_start=k, aux=aj)
        aj = info["aux"]
        st, _, at = bt.step(st, TB_(), k, at, draws=draws)
        for field in sj._fields:
            if field in ("step", "key"):
                continue
            for g, w in zip(jax.tree_util.tree_leaves(getattr(st, field)),
                            jax.tree_util.tree_leaves(getattr(sj, field))):
                np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-5, atol=1e-6,
                                           err_msg=f"step {k} {field}")
