"""The port's serve event layer (`repro_torch.serve.events`) and paced binds
against the JAX package (`tests/test_serve.py`'s cases).

JAX's threefry and Poisson draws cannot be reproduced from torch, so the
port's own sampler is held statistically (the Poisson mean within 3σ over
many rounds, the MMPP's burst share near p_up / (p_up + p_down), served ≤
capacity and queue ≥ 0), and JAX's draws are held through injection:
`ServePacing.advance` with JAX's uniforms and arrivals is bit-equal to
JAX's, and paced bound steps (PaME sparse, D-PSGD, PaME with a FaultModel
under pacing) match JAX's at atol 1e-5 (`_torch_parity.bound_parity`).
The paced runs between port binds (static pacing, always busy against
straggler = 1) are bitwise.  `test_batched_paced_lanes_match_unbatched`
has no counterpart yet: batched lanes are not ported.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.faults import FaultModel as JFaultModel
from repro.serve import events as jev
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core.faults import FaultModel
from repro_torch.core.scenarios import Scenario
from repro_torch.core.temporal import TemporalScenario
from repro_torch.core.topology import build_topology
from repro_torch.serve import events as tev
from repro_torch.serve.events import (
    ARRIVAL_PRESETS,
    ArrivalProcess,
    PacedCarry,
    ServePacing,
    expand_events,
    get_arrival,
    shrink_events,
)

from _torch_parity import binds, bound_parity, jax_pacing_draws, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, N = 8, 5


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(rng.standard_normal((M, 4, N)).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal((M, 4)).astype(np.float32))

    def grad_fn(p, b, k):
        ab, yb = b
        r = ab @ p - yb
        return 0.5 * torch.mean(r * r), ab.T @ r / r.shape[0]

    return grad_fn, (lambda k: (a, y)), torch.zeros(N)


# ---------------------------------------------------------------------------
# arrival processes
# ---------------------------------------------------------------------------
def test_arrival_presets_resolve():
    assert tuple(ARRIVAL_PRESETS) == tuple(jev.ARRIVAL_PRESETS)
    for name in ARRIVAL_PRESETS:
        proc = get_arrival(name)
        assert proc.name == name
        assert (proc.rate, proc.burst_rate, proc.p_up, proc.p_down) == (
            jev.ARRIVAL_PRESETS[name].rate, jev.ARRIVAL_PRESETS[name].burst_rate,
            jev.ARRIVAL_PRESETS[name].p_up, jev.ARRIVAL_PRESETS[name].p_down)
    assert tev.list_arrivals() == jev.list_arrivals()
    with pytest.raises(ValueError):
        get_arrival("nope")


def test_arrival_validation():
    with pytest.raises(ValueError):
        ArrivalProcess(rate=-1.0)
    with pytest.raises(ValueError):
        ArrivalProcess(p_up=1.5)
    with pytest.raises(ValueError):
        ServePacing(capacity=-1)
    with pytest.raises(ValueError):
        ServePacing(defer_threshold=-1)


def test_event_state_field_order_is_jaxs():
    assert tev.EventState._fields == jev.EventState._fields
    assert tev.PacedCarry._fields == jev.PacedCarry._fields


def test_event_clock_deterministic():
    pac = ServePacing(ArrivalProcess(name="b", rate=1.0, burst_rate=6.0),
                      capacity=2, defer_threshold=3)
    runs = []
    for _ in range(2):
        es = pac.init(M)
        trace = []
        for k in range(20):
            es, busy, _ = pac.advance(es, k)
            trace.append(es.queue.numpy())
        runs.append(np.stack(trace))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_poisson_rate_matches():
    """Mean arrivals per node per round within 3σ of the rate (σ of a mean
    of M·steps Poisson draws: sqrt(rate / (M·steps)))."""
    rate, steps = 2.0, 300
    pac = ServePacing(ArrivalProcess(rate=rate), capacity=100, defer_threshold=1000)
    es = pac.init(M)
    for k in range(steps):
        es, _, _ = pac.advance(es, k)
    mean = float(es.arrived.sum()) / (M * steps)
    assert abs(mean - rate) < 3 * np.sqrt(rate / (M * steps))


def test_mmpp_burst_share_is_stationary():
    """The burst chain's share of node-rounds is near its stationary value
    p_up / (p_up + p_down), within 0.02 (3σ of the chain's correlated
    mean over 64 nodes x 2000 rounds is about 0.0073); every round serves
    at most `capacity` a node and keeps every queue non-negative."""
    proc = ArrivalProcess(name="b", rate=0.5, burst_rate=6.0, p_up=0.1, p_down=0.3)
    pac = ServePacing(proc, capacity=3, defer_threshold=5)
    m, steps = 64, 2000
    es = pac.init(m)
    hi = 0
    for k in range(steps):
        prev = es
        es, busy, metrics = pac.advance(es, k)
        served = es.served - prev.served
        assert int(served.max()) <= pac.capacity and int(es.queue.min()) >= 0
        assert torch.equal(busy, es.queue > pac.defer_threshold)
        assert int(metrics["deferred_nodes"]) == int(busy.sum())
        hi += int(es.hi.sum())
    assert abs(hi / (m * steps) - proc.p_up / (proc.p_up + proc.p_down)) < 0.02
    assert int(es.served.sum()) <= int(es.arrived.sum())


def test_littles_law_accounting():
    pac = ServePacing(ArrivalProcess(rate=1.0), capacity=100, defer_threshold=5)
    es = pac.init(M)
    for k in range(50):
        es, _, _ = pac.advance(es, k)
    assert float(es.wait.sum()) == 0.0
    assert torch.equal(es.served, es.arrived)
    starved = ServePacing(ArrivalProcess(rate=1.0), capacity=0, defer_threshold=5)
    es = starved.init(M)
    for k in range(50):
        es, _, _ = starved.advance(es, k)
    assert int(es.served.sum()) == 0
    assert float(es.wait.sum()) > 0.0


@pytest.mark.parametrize("preset", ["steady", "bursty", "rush"])
def test_advance_with_jax_draws_is_bit_equal(preset):
    """30 rounds of JAX's clock and the port's with JAX's uniforms and
    arrivals injected: every field, the busy mask and the metrics equal."""
    jp = jev.ServePacing(jev.get_arrival(preset), capacity=3, defer_threshold=4)
    tp = ServePacing(get_arrival(preset), capacity=3, defer_threshold=4)
    ej, et = jp.init(M), tp.init(M)
    for k in range(30):
        u = jax_pacing_draws(jp, ej, k)
        ej, bj, mj = jp.advance(ej, jnp.int32(k))
        et, bt, mt = tp.advance(et, k, u=u)
        for field in ("hi", "queue", "arrived", "served", "wait"):
            got, want = getattr(et, field).numpy(), np.asarray(getattr(ej, field))
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=f"{preset} {k} {field}")
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        for key in mj:
            assert float(mt[key]) == float(mj[key]), key


def test_expand_events_preserves_counters():
    pac = ServePacing(ArrivalProcess(rate=2.0), capacity=1, defer_threshold=2)
    es = pac.init(M)
    for k in range(10):
        es, _, _ = pac.advance(es, k)
    grown = expand_events(es, 3)
    assert grown.queue.shape == (M + 3,)
    assert torch.equal(grown.arrived[:M], es.arrived)
    assert int(grown.arrived[M:].sum()) == 0 and not bool(grown.hi[M:].any())
    assert grown.key == es.key
    assert expand_events(es, 0) is es


def test_shrink_events_keeps_survivor_accounting():
    pac = ServePacing(ArrivalProcess(name="s", rate=3.0), capacity=2)
    es = pac.init(4)
    for k in range(6):
        es, _, _ = pac.advance(es, k)
    kept = shrink_events(es, [0, 1, 2])
    assert torch.equal(kept.arrived, es.arrived[:3])
    assert torch.equal(kept.wait, es.wait[:3])
    assert shrink_events(es, [0, 1, 2, 3]) is es


# ---------------------------------------------------------------------------
# paced binds (port against port)
# ---------------------------------------------------------------------------
def test_zero_rate_pacing_binds_unpaced_program():
    grad_fn, batch_fn, p0 = _problem()
    topo = build_topology("ring", M)
    alg = TALG.get_algorithm("dpsgd")
    b0 = alg.bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1), pacing=ServePacing(ArrivalProcess()),
                  device="cpu")
    assert not b0.paced and not b0.dynamic and not b0.carries_aux
    s0, _ = b0.run(1, p0, M, batch_fn, 20)
    su, _ = alg.bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1), device="cpu").run(
        1, p0, M, batch_fn, 20)
    assert torch.equal(s0.params, su.params)


def test_always_busy_equals_full_straggler():
    """A node that defers for load is exactly a straggler: the flooded
    paced run reproduces the straggler = 1 scenario bit for bit."""
    grad_fn, batch_fn, p0 = _problem()
    topo = build_topology("ring", M)
    alg = TALG.get_algorithm("dpsgd")
    flooded = ServePacing(ArrivalProcess(name="flood", rate=50.0), capacity=1,
                          defer_threshold=0)
    sp, hp = alg.bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1), pacing=flooded, device="cpu").run(
        1, p0, M, batch_fn, 15)
    ss, _ = alg.bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1),
                     scenario=Scenario(name="s", straggler=1.0), device="cpu").run(
        1, p0, M, batch_fn, 15)
    assert torch.equal(sp.params, ss.params)
    assert hp["deferred_nodes"][-1] == M


def test_paced_run_emits_event_metrics():
    grad_fn, batch_fn, p0 = _problem()
    topo = build_topology("ring", M)
    pac = ServePacing(ArrivalProcess(name="bursty", rate=0.5, burst_rate=8.0),
                      capacity=2, defer_threshold=4)
    bound = TALG.get_algorithm("pame").bind(grad_fn, topo, TALG.PaMEHp(nu=0.5, p=0.5),
                                            pacing=pac, device="cpu")
    assert bound.paced and bound.carries_aux
    _, hist = bound.run(0, p0, M, batch_fn, 25)
    for key in ("queue_depth", "served_reqs", "deferred_nodes"):
        assert key in hist and len(hist[key]) == 25
    assert all(0 <= d <= M for d in hist["deferred_nodes"])


def test_paced_composes_with_faults():
    grad_fn, batch_fn, p0 = _problem()
    topo = build_topology("ring", M)
    pac = ServePacing(ArrivalProcess(rate=3.0), capacity=1, defer_threshold=2)
    bound = TALG.get_algorithm("dpsgd").bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1), pacing=pac,
                                             faults=FaultModel(name="l", loss=0.3), device="cpu")
    assert bound.paced and bound.faulty
    _, hist = bound.run(0, p0, M, batch_fn, 15)
    assert "dropped_msgs" in hist and "deferred_nodes" in hist
    assert np.all(np.isfinite(hist["loss"]))


def test_paced_rejects_temporal():
    grad_fn, _, _ = _problem()
    topo = build_topology("ring", M)
    with pytest.raises(NotImplementedError, match="pacing cannot stack"):
        TALG.get_algorithm("dpsgd").bind(
            grad_fn, topo, TALG.DPSGDHp(), scenario=TemporalScenario(name="t", burst_down=0.1),
            pacing=ServePacing(ArrivalProcess(rate=1.0)), device="cpu")


def test_paced_aux_is_paced_carry():
    grad_fn, _, p0 = _problem()
    topo = build_topology("ring", M)
    pac = ServePacing(ArrivalProcess(rate=1.0), capacity=1)
    bound = TALG.get_algorithm("dpsgd").bind(grad_fn, topo, TALG.DPSGDHp(lr=0.1), pacing=pac,
                                             device="cpu")
    state = bound.init(0, TB.stack_params(p0, M))
    aux = bound.aux_init(state)
    assert isinstance(aux, PacedCarry) and aux.inner is None
    assert aux.events.queue.shape == (M,) and aux.events.key == bound.pace_key == 0
    with pytest.raises(TypeError, match="PacedCarry"):
        bound.step(state, None, 0)


# ---------------------------------------------------------------------------
# paced steps against JAX, draws injected (atol 1e-5)
# ---------------------------------------------------------------------------
PACE = dict(capacity=2, defer_threshold=3)


def _pacings():
    proc = dict(name="b", rate=1.0, burst_rate=6.0, p_up=0.2, p_down=0.2, seed=3)
    return (jev.ServePacing(jev.ArrivalProcess(**proc), **PACE),
            ServePacing(ArrivalProcess(**proc), **PACE))


@pytest.mark.parametrize("name,faulty", [("pame", False), ("dpsgd", False), ("pame", True)])
def test_paced_steps_match_jax(name, faulty):
    """Six paced steps on the regression fixture (8 nodes), the event clock
    deferring nodes: every state leaf and metric at atol 1e-5, the clocks
    exactly."""
    from _torch_parity import JB, TB_, W0_NP

    jp, tp = _pacings()
    jkw, tkw = {"pacing": jp}, {"pacing": tp}
    if faulty:
        jkw["faults"] = JFaultModel(name="l", loss=0.2, seed=2)
        tkw["faults"] = FaultModel(name="l", loss=0.2, seed=2)
    bj, bt = binds(name, jkw, tkw)
    assert bt.paced and bt.faulty == faulty
    out = bound_parity(name, bj, bt, jnp.asarray(W0_NP), torch.tensor(W0_NP), JB, TB_(), 6,
                       atol=1e-5)
    assert sum(float(mj["deferred_nodes"]) for mj, _ in out) > 0



# ---------------------------------------------------------------------------
# consensus-serving failover (tests/test_serve.py's cases)
# ---------------------------------------------------------------------------
def test_component_mean_params_per_component():
    from repro_torch.serve.serving import component_mean_params

    params = {"w": torch.as_tensor([[0.0, 2.0], [2.0, 4.0], [10.0, 20.0], [30.0, 40.0]]),
              "step": torch.tensor(7)}  # scalar leaves pass through
    out = component_mean_params(params, np.asarray([0, 0, 1, 1]))
    np.testing.assert_allclose(out["w"].numpy(),
                               [[1.0, 3.0], [1.0, 3.0], [20.0, 30.0], [20.0, 30.0]])
    assert int(out["step"]) == 7
    out = component_mean_params({"w": params["w"]}, None)
    np.testing.assert_allclose(out["w"].numpy(), np.full((4, 2), [10.5, 16.5]))


def test_component_mean_params_preserves_dtype_and_shape():
    from repro_torch.serve.serving import component_mean_params

    out = component_mean_params({"w": torch.ones((4, 2, 3), dtype=torch.bfloat16)},
                                np.asarray([0, 1, 0, 1]))
    assert out["w"].shape == (4, 2, 3) and out["w"].dtype == torch.bfloat16


def test_serve_round_rejects_unknown_policy():
    from repro_torch.configs import get_config
    from repro_torch.serve.serving import ServeLoop

    loop = ServeLoop(get_config("stablelm-1.6b", "smoke"), device="cpu")
    with pytest.raises(ValueError, match="unknown serving policy"):
        loop.serve_round({"w": torch.zeros((2, 3))}, policy="bogus")
