"""Batched seed and config lanes in the port (`Algorithm.bind_batched`,
`BatchedAlgorithm`, `engine.run_batched`, `lane_finals`) on the CPU.

Two contracts:

  * port lanes = port unbatched, bit for bit: lane (s, c) of a port grid
    reproduces the port's unbatched ``bind(hps_c)`` run started from key s
    (the same eager arithmetic, row by row), for every algorithm and for
    static, dynamic, temporal, fault and paced grids;
  * port lanes = JAX lanes, within rtol 5e-5 / atol 1e-5, with each lane's
    draws made from JAX's streams for that lane and injected through
    ``draws=`` (JAX's batched program is not its unbatched one, see
    tests/test_batched.py).

Sizes are tests/test_batched.py's (m = 8, n = 24 linear regression).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (  # noqa: E402
    _close,
    jax_compression_draws,
    jax_fault_draws,
    jax_fault_init_draws,
    jax_pacing_draws,
    jax_scenario_draws,
    jax_step_draws,
    jax_temporal_draws,
    jax_temporal_init_draws,
    one_torch_thread,  # noqa: F401
)
from repro.core import algorithms as JALG  # noqa: E402
from repro.core import faults as JFLT  # noqa: E402
from repro.core import scenarios as JSCEN  # noqa: E402
from repro.core import temporal as JTEMP  # noqa: E402
from repro.core.topology import build_topology as jbuild  # noqa: E402
from repro.serve import events as JEV  # noqa: E402
from repro_torch.core import algorithms as ALG  # noqa: E402
from repro_torch.core import baselines as B  # noqa: E402
from repro_torch.core import engine, mixing, pme  # noqa: E402
from repro_torch.core.faults import FaultModel  # noqa: E402
from repro_torch.core.pme import fold_in  # noqa: E402
from repro_torch.core.scenarios import Scenario  # noqa: E402
from repro_torch.core.temporal import TemporalScenario  # noqa: E402
from repro_torch.core.topology import build_topology  # noqa: E402
from repro_torch.kernels.gossip.ref import gather_terms_ref  # noqa: E402
from repro_torch.kernels.pme_average.ref import pme_average_ref  # noqa: E402
from repro_torch.serve.events import ArrivalProcess, ServePacing  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M, N = 8, 24


def _linreg_np(m=M, n=N, spn=24, seed=0):
    rng = np.random.default_rng(seed)
    w_star = rng.standard_normal(n)
    a = rng.standard_normal((m, spn, n))
    y = a @ w_star + 0.3 * rng.standard_normal((m, spn))
    return a.astype(np.float32), y.astype(np.float32)


A_NP, Y_NP = _linreg_np()


def _linreg(seed=0):
    """(batch, grad_fn, objective) of tests/test_batched.py's problem."""
    a, y = (A_NP, Y_NP) if seed == 0 else _linreg_np(seed=seed)
    a_t, y_t = torch.tensor(a), torch.tensor(y)

    def grad_fn(w, batch, key):
        aa, yy = batch
        r = aa @ w - yy
        return 0.5 * torch.mean(r ** 2), aa.T @ r / aa.shape[0]

    def objective(w):
        r = torch.einsum("mbn,n->mb", a_t, w) - y_t
        return torch.sum(0.5 * torch.mean(r ** 2, dim=1))

    return (a_t, y_t), grad_fn, objective


def _j_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * jnp.mean(r ** 2), aa.T @ r / aa.shape[0]


def grids(mod):
    """tests/test_batched.py's 2-config grids, for either registry."""
    return {
        "pame": [mod.PaMEHp(nu=0.3, p=0.3, gamma=1.01, sigma0=8.0),
                 mod.PaMEHp(nu=0.6, p=0.3, gamma=1.05, sigma0=4.0)],
        "dpsgd": [mod.DPSGDHp(lr=0.1), mod.DPSGDHp(lr=0.05)],
        "dfedsam": [mod.DFedSAMHp(lr=0.1, rho=0.01), mod.DFedSAMHp(lr=0.05, rho=0.05)],
        "choco": [mod.ChocoHp(lr=0.05, gossip_gamma=0.3), mod.ChocoHp(lr=0.02, gossip_gamma=0.5)],
        "beer": [mod.BeerHp(lr=0.05), mod.BeerHp(lr=0.02)],
        "anq_nids": [mod.AnqNidsHp(lr=0.1), mod.AnqNidsHp(lr=0.05)],
    }


ALL = sorted(grids(ALG))


def _topo():
    return build_topology("erdos_renyi", M, p=0.5, seed=1)


def _assert_lane_equal(ba, state, hist, lane, bound, key, batch, steps, objective, chunk):
    """Lane `lane` of a batched run equals `bound`'s unbatched run from
    `key`, bit for bit: params, every state tensor, every metric."""
    st, h = bound.run(key, torch.zeros(N), M, lambda k: batch, steps, objective_fn=objective,
                      tol_std=0.0 if chunk else 1e-3, chunk_size=chunk or 25)
    assert int(hist["steps_run"][lane]) == h["steps_run"]
    for got, want in zip(tree_leaves(tuple(state)), tree_leaves(tuple(st))):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got[lane], want), f"lane {lane}"
        else:
            assert int(got[lane]) == int(want)
    n = h["steps_run"]
    for k in ("loss", "objective"):
        np.testing.assert_array_equal(hist[k][:n, lane], np.asarray(h[k], np.float32),
                                      err_msg=f"lane {lane} {k}")
    for k in ("wire_bits_per_step", "wire_bits_total"):
        assert hist[k][lane] == pytest.approx(h[k], rel=1e-12)


# ---------------------------------------------------------------------------
# port lanes = port unbatched, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mixing_mode", ["sparse", "dense"])
@pytest.mark.parametrize("name", ALL)
def test_lane_matches_unbatched_run(name, mixing_mode):
    """Every lane of a 2-config × 2-seed grid reproduces the unbatched run
    of its config under its seed, bit for bit."""
    batch, grad_fn, objective = _linreg()
    topo, hps = _topo(), grids(ALG)[name]
    ba = ALG.get_algorithm(name).bind_batched(grad_fn, topo, hps, seeds=[0, 1],
                                              mixing=mixing_mode, device="cpu")
    assert ba.lanes == 4 and not ba.dynamic
    state, hist = ba.run(torch.zeros(N), M, lambda k: batch, 12, objective_fn=objective,
                         tol_std=0.0, chunk_size=6)
    assert hist["objective"].shape == (12, 4) and hist["loss"].shape == (12, 4)
    np.testing.assert_array_equal(hist["lane_config"], [0, 0, 1, 1])
    np.testing.assert_array_equal(hist["lane_seed"], [0, 1, 0, 1])
    assert ba.params_of(state).shape == (4, M, N)
    for lane in range(ba.lanes):
        c, s = int(hist["lane_config"][lane]), int(hist["lane_seed"][lane])
        bound = ALG.get_algorithm(name).bind(grad_fn, topo, hps[c], mixing=mixing_mode,
                                             device="cpu")
        _assert_lane_equal(ba, state, hist, lane, bound, s, batch, 12, objective, 6)


def _lane_bound(name, hps, lane_seed, **kw):
    """The unbatched bind of one lane: its network, fault and pace keys
    folded with its seed, as `bind_batched` folds them."""
    batch, grad_fn, _ = _linreg()
    bound = ALG.get_algorithm(name).bind(grad_fn, _topo(), hps, device="cpu", **kw)
    arrays = bound.scen_arrays._replace(key=fold_in(bound.scen_arrays.key, lane_seed))
    bound.scen_arrays = arrays
    if bound.faulty:
        bound.fault_key = fold_in(int(bound.faults.seed), lane_seed)
    if bound.paced:
        bound.pace_key = fold_in(int(bound.pacing.process.seed), lane_seed)
    return bound


def _pacing():
    return ServePacing(ArrivalProcess(name="bursty", rate=0.5, burst_rate=6.0),
                       capacity=2, defer_threshold=3)


DYNAMIC = {
    "scenario": ("dpsgd", dict(scenario=Scenario(name="flaky", churn=0.1, edge_drop=0.2,
                                                 seed=5))),
    "temporal": ("pame", dict(scenario=TemporalScenario(
        name="stale", straggler=0.4, staleness=2, burst_down=0.05, burst_up=0.3, seed=4))),
    "faults": ("choco", dict(faults=FaultModel(name="lossy", loss=0.2, burst_down=0.1,
                                               burst_up=0.5, seed=3))),
    "paced": ("dpsgd", dict(pacing=_pacing())),
}


@pytest.mark.parametrize("form", sorted(DYNAMIC))
def test_dynamic_lanes_match_unbatched(form):
    """Dynamic, temporal, fault (CHOCO with replicas) and paced grids: each
    lane equals the unbatched bind with its seed folded into the network,
    fault and pace keys, bit for bit; the same seed under both configs sees
    the same sample path, different seeds different ones."""
    name, kw = DYNAMIC[form]
    batch, grad_fn, objective = _linreg()
    hps = grids(ALG)[name]
    ba = ALG.get_algorithm(name).bind_batched(grad_fn, _topo(), hps, seeds=[0, 1],
                                              device="cpu", **kw)
    assert ba.dynamic and ba.lanes == 4
    state, hist = ba.run(torch.zeros(N), M, lambda k: batch, 12, objective_fn=objective,
                         tol_std=0.0, chunk_size=6)
    for lane in range(ba.lanes):
        c, s = int(hist["lane_config"][lane]), int(hist["lane_seed"][lane])
        _assert_lane_equal(ba, state, hist, lane, _lane_bound(name, hps[c], s, **kw), s,
                           batch, 12, objective, 6)
    # seeds paired across configs: lanes (c0 s0, c0 s1, c1 s0, c1 s1) see
    # one sample path a seed (a series the network, not the config, sets)
    series = hist[{"scenario": "wire_bits", "temporal": "stale_nodes",
                   "faults": "dropped_msgs", "paced": "deferred_nodes"}[form]]
    np.testing.assert_array_equal(series[:, 0], series[:, 2])
    np.testing.assert_array_equal(series[:, 1], series[:, 3])
    assert (series[:, 0] != series[:, 1]).any()
    if form == "temporal":
        assert hist["staleness_hist"].shape == (4, 3)
        assert hist["staleness_hist"][:, 1:].sum() > 0


def test_per_lane_termination_freezes_each_lane():
    """The std rule fires per lane; a stopped lane's state is its
    triggering step's, bit for bit, while the slower lane runs on."""
    batch, grad_fn, objective = _linreg(seed=3)
    topo = build_topology("complete", M)
    hps = [ALG.PaMEHp(nu=0.5, p=0.5, gamma=1.05, sigma0=8.0),
           ALG.PaMEHp(nu=0.5, p=0.5, gamma=1.001, sigma0=0.5)]
    ba = ALG.get_algorithm("pame").bind_batched(grad_fn, topo, hps, seeds=[0], device="cpu")
    state, hist = ba.run(torch.zeros(N), M, lambda k: batch, 400, objective_fn=objective,
                         tol_std=1e-3, chunk_size=25)
    steps_run = hist["steps_run"]
    assert steps_run[0] != steps_run[1]
    assert hist["steps_dispatched"] >= max(steps_run)
    for lane, cfg in enumerate(hps):
        bound = ALG.get_algorithm("pame").bind(grad_fn, topo, cfg, device="cpu")
        _assert_lane_equal(ba, state, hist, lane, bound, 0, batch, 400, objective, None)
    finals = ALG.lane_finals(hist)
    np.testing.assert_array_equal(
        finals, [hist["objective"][steps_run[lane] - 1, lane] for lane in range(2)])
    assert np.isfinite(finals).all()


def test_bind_batched_refuses_static_fields_and_non_float_sweeps():
    batch, grad_fn, _ = _linreg()
    topo = build_topology("ring", 6)
    with pytest.raises(ValueError, match="shapes the traced program"):
        ALG.get_algorithm("pame").bind_batched(
            grad_fn, topo, [ALG.PaMEHp(p=0.2), ALG.PaMEHp(p=0.4)], device="cpu")
    with pytest.raises(ValueError, match="shapes the traced program"):
        ALG.get_algorithm("dfedsam").bind_batched(
            grad_fn, topo, [ALG.DFedSAMHp(local_steps=1), ALG.DFedSAMHp(local_steps=2)],
            device="cpu")
    with pytest.raises(ValueError, match="shapes the traced program"):
        ALG.get_algorithm("anq_nids").bind_batched(
            grad_fn, topo, [ALG.AnqNidsHp(qsgd_levels=4), ALG.AnqNidsHp(qsgd_levels=8)],
            device="cpu")
    with pytest.raises(TypeError):
        ALG.get_algorithm("dpsgd").bind_batched(grad_fn, topo, [ALG.PaMEHp()], device="cpu")
    with pytest.raises(ValueError, match="at least one seed"):
        ALG.get_algorithm("dpsgd").bind_batched(grad_fn, topo, seeds=[], device="cpu")

    @dataclasses.dataclass(frozen=True)
    class OddHp:
        reps: int = 1

    spec = ALG.Algorithm(
        name="odd", hp_cls=OddHp,
        init=lambda key, stacked, ctx, batch0: B.dpsgd_init(key, stacked),
        step=lambda s, b_, ctx: B.dpsgd_step(s, b_, ctx.grad_fn, ctx.mixer, 0.1),
        wire_bits=lambda topo_, hps, n_: 0.0,
    )
    with pytest.raises(ValueError, match="non-float"):
        spec.bind_batched(grad_fn, topo, [OddHp(reps=1), OddHp(reps=2)], device="cpu")
    # PaME's setup-realized fields may differ: each config its own t_i / kappa_i
    ba = ALG.get_algorithm("pame").bind_batched(
        grad_fn, topo, [ALG.PaMEHp(nu=0.3, kappa_lo=2), ALG.PaMEHp(nu=0.6, kappa_lo=4)],
        device="cpu")
    lanes = ba.ctx.extras["topo_arrays"].lanes
    assert not torch.equal(lanes[0].kappa, lanes[1].kappa)
    with pytest.raises(NotImplementedError, match="TemporalScenario"):
        ALG.get_algorithm("dpsgd").bind_batched(
            grad_fn, topo, seeds=[0, 1], scenario=TemporalScenario(name="t", straggler=0.2),
            pacing=_pacing(), device="cpu")


def test_batched_static_wire_accounting_per_lane():
    """A static grid charges each lane its config's Eq.-(8) rate."""
    batch, grad_fn, objective = _linreg()
    topo, hps = _topo(), grids(ALG)["pame"]
    ba = ALG.get_algorithm("pame").bind_batched(grad_fn, topo, hps, seeds=[0, 1],
                                                device="cpu")
    _, hist = ba.run(torch.zeros(N), M, lambda k: batch, 8, objective_fn=objective,
                     tol_std=0.0, chunk_size=4)
    for lane in range(ba.lanes):
        bound = ALG.get_algorithm("pame").bind(grad_fn, topo, hps[int(hist["lane_config"][lane])],
                                               device="cpu")
        assert hist["wire_bits_per_step"][lane] == pytest.approx(bound.wire_bits(N))
    assert hist["wire_bits_per_step"][0] != hist["wire_bits_per_step"][2]
    np.testing.assert_array_equal(hist["wire_bits_total"],
                                  hist["wire_bits_per_step"] * hist["steps_run"])
    assert ba.wire_bits_for(torch.zeros(N)) == pytest.approx(hist["wire_bits_per_step"][0])


def test_engine_run_batched_per_lane_metrics():
    """engine.run_batched: per-lane [steps, L] buffers, [L] steps_run, and
    host leaves (a per-lane counter) restored per lane at each stop."""

    def step(state, batch):
        x, count = state
        new = x + torch.arange(1.0, x.shape[0] + 1.0)[:, None]
        return (new, count + 1), {"loss_mean": new.mean(dim=1)}

    state0 = (torch.zeros((3, 2)), np.zeros(3, np.int64))
    state, metrics, info = engine.run_batched(
        step, state0, lambda k: None, 6, lanes=3, chunk_size=4, params_of=lambda s: s[0])
    assert metrics["loss_mean"].shape == (6, 3)
    np.testing.assert_allclose(metrics["loss_mean"][:, 2], 3.0 * np.arange(1, 7))
    np.testing.assert_array_equal(info["steps_run"], [6, 6, 6])
    np.testing.assert_array_equal(state[1], [6, 6, 6])
    # per-lane stop: a lane whose objective is constant stops at step 3
    slope = torch.tensor([0.0, 1.0])

    def step2(state, batch):
        x, count = state
        return (x + slope[:, None], count + 1), {"loss_mean": x[:, 0]}

    state, metrics, info = engine.run_batched(
        step2, (torch.zeros((2, 1)), np.zeros(2, np.int64)), lambda k: None, 8, lanes=2,
        chunk_size=4, params_of=lambda s: s[0][:, None], objective_fn=lambda p: p.sum(),
        tol_std=1e-3)
    np.testing.assert_array_equal(info["steps_run"], [3, 8])
    np.testing.assert_array_equal(state[1], [3, 8])
    assert state[0][1, 0] == 8.0 and state[0][0, 0] == 0.0


def test_lane_finals():
    hist = {"objective": np.arange(12.0).reshape(4, 3), "steps_run": np.array([1, 4, 2])}
    np.testing.assert_array_equal(ALG.lane_finals(hist), [0.0, 10.0, 5.0])
    np.testing.assert_array_equal(ALG.lane_finals(hist, "objective"), [0.0, 10.0, 5.0])


# ---------------------------------------------------------------------------
# the exchange: one call a leaf for all lanes, no lane reads another
# ---------------------------------------------------------------------------
def _form_kw(form):
    """bind_batched's network arguments for a form of DYNAMIC ("static":
    none)."""
    return {} if form == "static" else DYNAMIC[form][1]


def _steps(ba, state, batch, n):
    """`n` steps of a batched bind from `state` (its carry made here):
    (state, the last step's metrics)."""
    aux = ba.aux_init(state) if ba.carries_aux else None
    metrics = None
    for k in range(n):
        if ba.carries_aux:
            state, metrics, aux = ba.step(state, batch, k, aux)
        elif ba.dynamic:
            state, metrics = ba.step(state, batch, k)
        else:
            state, metrics = ba.step(state, batch)
    return state, metrics


# the static cases keep their ids; each form of DYNAMIC on its algorithm
EXCHANGE_CASES = [pytest.param(n, mm, "static", id=f"{n}-{mm}") for n, mm in
                  (("pame", "sparse"), ("pame", "dense"), ("dpsgd", "sparse"),
                   ("beer", "sparse"))] + [
    pytest.param(DYNAMIC[form][0], "sparse", form, id=f"{DYNAMIC[form][0]}-{form}")
    for form in sorted(DYNAMIC)]


@pytest.mark.parametrize("name,mixing_mode,form", EXCHANGE_CASES)
def test_exchange_calls_do_not_grow_with_lanes(name, mixing_mode, form, monkeypatch):
    """The count of exchange calls a step (the kernel routes' wrappers,
    forced on the CPU) is the same for 1 lane and for 8: the port's
    counterpart of test_batched_sweep_traces_step_once.  Under each
    network form too: the lanes' realizations are folded, so the exchange
    (CHOCO's replica mix under faults) is one call a leaf for all lanes."""
    from repro_torch.kernels.gossip import ops as gops
    from repro_torch.kernels.pme_average import ops as pops

    monkeypatch.setenv(mixing.ENV_VAR, "kernel")
    calls = []
    real_g, real_p = gops.gather_terms_kernel, pops.pme_average
    monkeypatch.setattr(gops, "gather_terms_kernel",
                        lambda *a, **k: calls.append("g") or real_g(*a, **k))
    monkeypatch.setattr(pops, "pme_average", lambda *a, **k: calls.append("p") or real_p(*a, **k))
    batch, grad_fn, _ = _linreg()
    params0 = {"w": torch.zeros(N), "b": torch.zeros(3)}

    def gf(p, b, key):
        loss, g = grad_fn(p["w"], b, key)
        return loss + 0.0 * p["b"].sum(), {"w": g, "b": torch.zeros(3)}

    counts = {}
    for seeds in ([0], [0, 1, 2, 3, 4, 5, 6, 7]):
        ba = ALG.get_algorithm(name).bind_batched(gf, _topo(), [grids(ALG)[name][0]],
                                                  seeds=seeds, mixing=mixing_mode, device="cpu",
                                                  **_form_kw(form))
        state = ba.init(params0, M, batch)
        calls.clear()
        _steps(ba, state, batch, 3)
        counts[len(seeds)] = list(calls)
    assert counts[1] == counts[8] and len(counts[1]) == 3 * (4 if name == "beer" else 2)


NAN_CASES = [pytest.param(n, mm, "static", id=f"{n}-{mm}") for n, mm in
             (("pame", "sparse"), ("pame", "dense"), ("dpsgd", "sparse"),
              ("anq_nids", "sparse"), ("choco", "dense"))] + [
    pytest.param(DYNAMIC[form][0], "sparse", form, id=f"{DYNAMIC[form][0]}-{form}")
    for form in sorted(DYNAMIC)]


@pytest.mark.parametrize("name,mixing_mode,form", NAN_CASES)
@pytest.mark.parametrize("impl", ["slots", "segsum"])
def test_nan_lane_leaves_other_lanes_bit_equal(name, mixing_mode, form, impl, monkeypatch):
    """A lane poisoned with NaN changes no other lane's state or metrics,
    on a static network and under each network form (the folded
    realization's tables, the staleness ring and the replica blocks keep
    every lane to its rows)."""
    monkeypatch.setenv(mixing.ENV_VAR, impl)
    batch, grad_fn, _ = _linreg()
    ba = ALG.get_algorithm(name).bind_batched(grad_fn, _topo(), grids(ALG)[name],
                                              seeds=[0, 1], mixing=mixing_mode, device="cpu",
                                              **_form_kw(form))
    runs = []
    for poison in (False, True):
        state = ba.init(torch.zeros(N), M, batch)
        if poison:
            ba.params_of(state)[1, 3] = float("nan")
        runs.append(_steps(ba, state, batch, 3))
    (clean, mc), (dirty, md) = runs
    assert torch.isnan(ba.params_of(dirty)[1]).any()
    for got, want in zip(tree_leaves(tuple(dirty)), tree_leaves(tuple(clean))):
        if isinstance(want, torch.Tensor):
            for lane in (0, 2, 3):
                assert torch.equal(got[lane], want[lane]), lane
    for key in mc:
        for lane in (0, 2, 3):
            assert torch.equal(md[key][lane], mc[key][lane]), key


def test_dynamic_grid_builds_no_per_lane_bind(monkeypatch):
    """Under a scenario, faults or pacing, bind_batched builds no
    BoundAlgorithm and its step runs none: one step of the algorithm over
    the folded rows."""
    built = []
    monkeypatch.setattr(ALG.BoundAlgorithm, "__init__",
                        lambda self, *a, **k: built.append(1) or None)
    monkeypatch.setattr(ALG.BoundAlgorithm, "step", lambda *a, **k: built.append(2))
    batch, grad_fn, _ = _linreg()
    steps = []
    real_step = ALG.get_algorithm("dpsgd").step
    spec = dataclasses.replace(ALG.get_algorithm("dpsgd"),
                               step=lambda st, b, ctx: steps.append(1) or real_step(st, b, ctx))
    for form in sorted(DYNAMIC):
        name, kw = DYNAMIC[form]
        alg = spec if name == "dpsgd" else ALG.get_algorithm(name)
        ba = alg.bind_batched(grad_fn, _topo(), grids(ALG)[name], seeds=[0, 1], device="cpu",
                              **kw)
        assert ba.dynamic and not hasattr(ba, "_bounds")
        _steps(ba, ba.init(torch.zeros(N), M, batch), batch, 2)
    assert not built
    assert len(steps) == 2 * 2  # the scenario and paced grids: one step call a step


def test_folded_realization_offsets_every_slot():
    """`fold_arrays` offsets every slot of lane l by l·m, padding and self
    slots included; the realization built from the lanes' masks over the
    folded arrays equals each lane's own, row for row, with [L] directed
    edges; the sparse mixer gathers over the offset table only."""
    from repro_torch.core import scenarios as S

    topo = build_topology("star", 5)  # leaves have one neighbour: padding slots
    scen = Scenario(name="flaky", churn=0.2, edge_drop=0.3, straggler=0.2, seed=2)
    base = S.make_scenario_arrays(topo, scen)
    folded = S.fold_arrays(base, 3)
    m, d = base.nbrs.shape
    assert folded.lanes == 3 and folded.nbrs.shape == (3 * m, d)
    assert bool((~base.valid).any())
    for lane in range(3):
        sl = slice(lane * m, (lane + 1) * m)
        for got, want in ((folded.nbrs[sl], base.nbrs), (folded.nbrs_full[sl], base.nbrs_full)):
            assert ((got >= lane * m) & (got < (lane + 1) * m)).all()
            assert torch.equal(got - lane * m, want)
        assert torch.equal(folded.valid[sl], base.valid)
        assert torch.equal(folded.is_self[sl], base.is_self)
    arrays = [base._replace(key=fold_in(base.key, s)) for s in (0, 1, 2)]
    masks = [S.sample_masks(scen, a, 4) for a in arrays]
    r = S.realization_from_masks(folded, *(torch.cat(x) for x in zip(*masks)))
    rs = [S.realization_from_masks(a, *mk) for a, mk in zip(arrays, masks)]
    assert r.directed_edges.shape == (3,)
    for got, want in zip(r, S.fold_realizations(rs)):
        assert torch.equal(got, want)
    mixer = S.scenario_mixer(folded, r, "sparse")
    assert torch.equal(mixer.pm.nbrs, folded.nbrs_full)
    x = torch.randn(3 * m, 4)
    x[m + 1] = float("nan")  # lane 1 only
    out = mixer.mix(x)
    assert torch.isfinite(out[:m]).all() and torch.isfinite(out[2 * m:]).all()
    for lane, (a, rl) in enumerate(zip(arrays, rs)):
        if lane == 1:
            continue
        want = S.scenario_mixer(a, rl, "sparse").mix(x[lane * m:(lane + 1) * m])
        assert torch.equal(out[lane * m:(lane + 1) * m], want)
    for mode in ("dense", "matrix"):
        got = S.scenario_mixer(folded, r, mode).mix(x)
        for lane in (0, 2):
            want = S.scenario_mixer(arrays[lane], rs[lane], mode).mix(
                x[lane * m:(lane + 1) * m])
            assert torch.equal(got[lane * m:(lane + 1) * m], want), mode


def test_fold_padded_offsets_every_slot():
    topo = build_topology("star", 5)
    mx = mixing.make_mixer(topo, "sparse")
    folded = mixing.fold_padded(mx.pm, 3)
    assert folded.nbrs.shape == (15, mx.pm.nbrs.shape[1])
    for lane in range(3):
        rows = folded.nbrs[lane * 5:(lane + 1) * 5].long()
        assert ((rows >= lane * 5) & (rows < (lane + 1) * 5)).all()
        assert torch.equal(rows - lane * 5, mx.pm.nbrs.long())
    assert torch.equal(folded.pad, mx.pm.pad.repeat(3, 1))


def test_lane_plain_versions_equal_a_loop():
    """Each kernel's plain version on the lane form equals a loop of the
    single-lane call, and one lane equals today's call."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((3, 5, 40), generator=g)
    masks = torch.rand((3, 5, 40), generator=g) < 0.3
    a = (torch.rand((3, 5, 5), generator=g) < 0.5).float()
    out = pme_average_ref(w, masks.float(), a)
    for lane in range(3):
        assert torch.equal(out[lane], pme_average_ref(w[lane], masks[lane].float(), a[lane]))
    assert torch.equal(pme_average_ref(w[:1], masks[:1].float(), a[:1])[0],
                       pme_average_ref(w[0], masks[0].float(), a[0]))
    # gossip, design (a): the folded table through the plain version equals
    # one call a lane on the lane's own table (finite values)
    pm = mixing.make_mixer(_topo(), "sparse").pm
    folded = mixing.fold_padded(pm, 3)
    x = torch.randn((3 * M, 17), generator=g)
    (got,) = gather_terms_ref(folded.nbrs, [(folded.w, x)], pad=folded.pad)
    for lane, xl in enumerate(x.chunk(3)):
        (want,) = gather_terms_ref(pm.nbrs, [(pm.w, xl)], pad=pm.pad)
        torch.testing.assert_close(got[lane * M:(lane + 1) * M], want, rtol=0, atol=0)
        (slots,) = mixing.gather_terms(pm.nbrs, [(pm.w, xl)], impl="slots")
        (fslots,) = mixing.gather_terms(folded.nbrs, [(folded.w, x)], impl="slots")
        assert torch.equal(fslots[lane * M:(lane + 1) * M], slots)


def test_dense_exchange_lanes_equal_one_lane_each():
    """pme_average_pytree on an [L, m, m] selection with per-lane keys
    equals one call a lane, exact and Bernoulli masks."""
    g = torch.Generator().manual_seed(1)
    leaves = {"a": torch.randn((3 * 4, 6, 5), generator=g), "b": torch.randn((3 * 4,), generator=g)}
    a = (torch.rand((3, 4, 4), generator=g) < 0.6).float()
    for mode in ("exact", "bernoulli"):
        got = pme.pme_average_pytree(np.array([11, 12, 13]), leaves, a, 0.4, mode=mode)
        for lane, key in enumerate((11, 12, 13)):
            part = {k: v[lane * 4:(lane + 1) * 4] for k, v in leaves.items()}
            want = pme.pme_average_pytree(key, part, a[lane], 0.4, mode=mode)
            for k in leaves:
                assert torch.equal(got[k][lane * 4:(lane + 1) * 4], want[k]), (mode, k)


# ---------------------------------------------------------------------------
# port lanes = JAX lanes, draws injected from each lane's JAX streams
# ---------------------------------------------------------------------------
def _lane(tree, lane):
    return jax.tree_util.tree_map(lambda x: x[lane], tree)


def _jax_lane_draws(name, jba, sj, aj, k, jbatch):
    """Each lane's draws (`BoundAlgorithm.step`'s format) from JAX's
    streams for that lane: its network, fault and pace keys, and the
    algorithm's own draws from its state key."""
    out = []
    kk = jnp.asarray(k, jnp.int32)
    realized = name == "pame"  # only PaME's draws read the realization
    for lane in range(jba.lanes):
        d, jr, busy = {}, None, None
        arr = None
        if jba.scen_arrays is not None:
            arr = jba.scen_arrays._replace(key=jba._scen_keys[lane])
        if jba.paced:
            es = _lane(aj.events, lane)
            d["pacing"] = jax_pacing_draws(jba.pacing, es, k)
            if realized:
                busy = jba.pacing.advance(es, kk)[1]
        if jba.faulty:
            fkey = jba._fault_keys[lane]
            d["scenario"] = jax_scenario_draws(arr, k)
            d["faults"] = jax_fault_draws(fkey, k, arr.m, arr.nbrs.shape[1])
        elif jba.temporal:
            d["temporal"] = jax_temporal_draws(jba.scenario, arr, k)
            jr = JTEMP.advance(jba.scenario, arr, _lane(aj.ts, lane), kk)[1]
        elif jba.dynamic:
            d["scenario"] = jax_scenario_draws(arr, k)
            if realized:
                edge_up, alive, strag = JSCEN.sample_masks(jba.scenario, arr, kk)
                if busy is not None:
                    strag = strag | busy
                jr = JSCEN.realization_from_masks(arr, edge_up, alive, strag)
        lane_state = _lane(sj, lane)
        if name == "pame":
            ta = _lane(jba._lane_extras["topo_arrays"], lane)
            d["algo"] = jax_step_draws(lane_state.key, int(lane_state.step), lane_state.params,
                                       ta, jba.hps_list[int(jba.lane_config[lane])],
                                       realization=jr)
        else:
            d["algo"] = jax_compression_draws(
                name, jax.random.PRNGKey(int(jba.lane_seed[lane])), k,
                lane_state.params) or None
        out.append(d)
    return out


JAX_FORMS = [(name, "static") for name in ALL] + [
    ("dpsgd", "scenario"), ("pame", "temporal"), ("choco", "faults"), ("dpsgd", "paced")]


@pytest.mark.parametrize("name,form", JAX_FORMS)
def test_lanes_match_jax_bind_batched(name, form):
    """The port's bind_batched against JAX's on the same 2-config × 2-seed
    grid (one seed for the temporal grid), three steps, each lane's draws
    from JAX's streams injected: every state leaf and every metric JAX
    reports within rtol 5e-5, atol 1e-5."""
    jkw, tkw = {}, {}
    if form != "static":
        _, kw = DYNAMIC[form]
        tkw = kw
        jkw = {
            "scenario": lambda: dict(scenario=JSCEN.Scenario(name="flaky", churn=0.1,
                                                             edge_drop=0.2, seed=5)),
            "temporal": lambda: dict(scenario=JTEMP.TemporalScenario(
                name="stale", straggler=0.4, staleness=2, burst_down=0.05, burst_up=0.3,
                seed=4)),
            "faults": lambda: dict(faults=JFLT.FaultModel(name="lossy", loss=0.2,
                                                          burst_down=0.1, burst_up=0.5, seed=3)),
            "paced": lambda: dict(pacing=JEV.ServePacing(
                JEV.ArrivalProcess(name="bursty", rate=0.5, burst_rate=6.0),
                capacity=2, defer_threshold=3)),
        }[form]()
    seeds = [0] if form == "temporal" else [0, 1]
    jhps, thps = grids(JALG)[name], grids(ALG)[name]
    jtopo = jbuild("erdos_renyi", M, p=0.5, seed=1)
    jba = JALG.get_algorithm(name).bind_batched(_j_grad, jtopo, jhps, seeds=seeds, **jkw)
    batch, grad_fn, _ = _linreg()
    tba = ALG.get_algorithm(name).bind_batched(grad_fn, _topo(), thps, seeds=seeds,
                                               device="cpu", **tkw)
    jbatch = (jnp.asarray(A_NP), jnp.asarray(Y_NP))
    # each package its own buffers (the port's steps update in place)
    sj = jba.init(jnp.zeros(N), M, jbatch)
    st = tba.init(torch.zeros(N), M, batch)
    aj = at = None
    if jba.carries_aux:
        aj = jba.aux_init(sj)
        u0 = None
        if jba.faulty:
            u0 = [jax_fault_init_draws(jba._fault_keys[lane], M, jba.scen_arrays.nbrs.shape[1])
                  for lane in range(jba.lanes)]
        elif jba.temporal:
            u0 = [jax_temporal_init_draws(jba.scen_arrays._replace(key=jba._scen_keys[lane]))
                  for lane in range(jba.lanes)]
        at = tba.aux_init(st, u=u0)
    jstep = jax.jit(jba.step)  # one compile, not one a primitive
    for k in range(3):
        draws = _jax_lane_draws(name, jba, sj, aj, k, jbatch)
        if jba.carries_aux:
            sj, mj, aj = jstep(sj, jbatch, jnp.asarray(k, jnp.int32), aj)
            st, mt, at = tba.step(st, batch, k, at, draws=draws)
        elif jba.dynamic:
            sj, mj = jstep(sj, jbatch, jnp.asarray(k, jnp.int32))
            st, mt = tba.step(st, batch, k, draws=draws)
        else:
            sj, mj = jstep(sj, jbatch)
            st, mt = tba.step(st, batch, draws=draws)
        for lane in range(jba.lanes):
            # lane by lane: the replicated states' views (hats, reps) are
            # properties of one lane's layout
            tl, jl = ALG._lane_of(st, lane), _lane(sj, lane)
            for field in jl._fields:
                if field in ("step", "key"):
                    continue
                for g, w in zip(tree_leaves(getattr(tl, field)),
                                jax.tree_util.tree_leaves(getattr(jl, field))):
                    _close(g, w, 5e-5, 1e-5, f"{name}/{form} step {k} lane {lane} {field}")
        for key, w in mj.items():
            assert key in mt, f"{name}/{form} step {k}: metric {key} missing"
            _close(torch.as_tensor(mt[key]), w, 5e-5, 1e-5, f"{name}/{form} step {k} {key}")


def test_chip_smoke_path_h_rehearsal(capsys):
    """`chip_smoke.py`'s path H (H2, H3, H4) and parity phase H (its
    network forms included) at tiny sizes on the CPU: the lanes'
    accuracies and losses pass their checks, and the parity phase's
    batched and unbatched steps coincide bit for bit, the NaN lane stays in
    its lane (both routes are plain on the CPU)."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from repro_torch.configs import get_config

    cpu = torch.device("cpu")
    cs.HELD = 128  # held-out images a lane's accuracy reads
    cs.H_SEEDS = 2  # lanes of H2's batched run and of H3
    steps = dict(cs.H_STEPS, cnn=8, resnet=4, profile=1, dynamic=1)
    rows = cs.path_h2(cpu, spec=dict(cs.FMNIST, n=1024), steps=steps)
    assert [len(rows[f"H2-L{n}"]["accuracy"]) for n in (1, cs.H_SEEDS)] == [1, cs.H_SEEDS]
    assert [len(rows[f"H2dyn-L{n}"]["lane_final_loss"]) for n in (1, cs.H_SEEDS)] == [
        1, cs.H_SEEDS]
    rows.update(cs.path_h3(cpu, spec=dict(cs.CIFAR, n=768), steps=steps, batch=8))
    assert len(rows["H3"]["lane_final_loss"]) == cs.H_SEEDS
    rows.update(cs.path_h4(cpu, spec=dict(cs.FMNIST, n=1024), steps=steps))
    for form in ("temporal", "faults", "paced"):
        assert [len(rows[f"H4-{form}-L{n}"]["lane_final_loss"]) for n in (1, cs.H_SEEDS)] == [
            1, cs.H_SEEDS]
    parity = cs.path_h_parity(cpu, cfg=get_config("stablelm-1.6b", "smoke").replace(n_layers=1),
                              batch=1, seq=16, cnn_sizes={"batch": 2})
    assert set(parity) == {"pame-sparse", "pame-dense-exact", "dpsgd-bf16", "cnn-pame-sparse",
                           "cnn-scenario", "cnn-temporal", "cnn-faults", "cnn-paced"}
    assert all(r["bit_equal"] and r["nan_lane_isolated"] for r in parity.values())
    out = capsys.readouterr().out
    assert '"phase": "parity_h"' in out and '"run": "H3"' in out
