"""Helpers shared by the tests/test_torch_*.py parity suites.

JAX's threefry streams cannot be reproduced from torch, so parity runs the
JAX step with its own key and recomputes the same draws outside it (the
same fold_in chain as `repro.core.pame.pame_step`), then hands them to the
port as injected draws.

In a pytest-xdist worker, importing this module gives torch one intra-op
thread, and the processes a test starts one OpenMP thread
(``OMP_NUM_THREADS``, unless it is set already).  Torch's default of a
thread per core in each of several workers oversubscribes the CPU, where
its OpenMP threads spin: the port's test files took 1127 s of wall time
with six workers on 8 cores, 695 s with one thread a process.  Tests that
need one thread for bit-equality also set it themselves.
"""
import os

if "PYTEST_XDIST_WORKER" in os.environ:
    os.environ.setdefault("OMP_NUM_THREADS", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import pme as jpme  # noqa: E402

if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def to_t(x, dtype=None):
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def to_np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# fold_in tags of each baseline's compressions in `repro.core.baselines`,
# under the port's `draws=` names
COMPRESSION_TAGS = {"choco": {"q": 7}, "beer": {"h": 3, "z": 5}, "anq_nids": {"q": 11}}


def jax_compression_draws(name, key, step, params):
    """The uniforms baseline `name`'s step `step` draws for its compressions
    (`_compress_tree`: fold_in(fold_in(fold_in(key, step), tag), leaf)),
    one [m, n] tensor per leaf: f32 for rand-k, the leaf's type for QSGD
    (`jax.random.bernoulli` draws in the type of its probability)."""
    k = jax.random.fold_in(key, step)
    leaves = jax.tree_util.tree_leaves(params)
    draws = {}
    for field, tag in COMPRESSION_TAGS.get(name, {}).items():
        kt = jax.random.fold_in(k, tag)
        draws[field] = [
            to_t(jax.random.uniform(
                jax.random.fold_in(kt, idx),
                (leaf.shape[0], int(np.prod(leaf.shape[1:]))),
                leaf.dtype if name == "anq_nids" else jnp.float32,
            ))
            for idx, leaf in enumerate(leaves)
        ]
    return draws


def jax_step_draws(key, step, params, topo_arrays, cfg, realization=None):
    """The selection and per-leaf masks (dense exchange) or class offsets
    (compressed exchange) `repro.core.pame.pame_step` draws at `step` from
    `key`, as torch tensors in the port's `draws=` format.  Under a JAX
    `realization` the selection is the realized one (participating
    receivers, surviving edges)."""
    k_sel, k_mask = (jax.random.fold_in(key, step * 3 + i) for i in range(2))
    comm = (jnp.asarray(step, jnp.int32) % topo_arrays.kappa) == 0
    survivors = None
    if realization is not None:
        comm = comm & realization.participating
        survivors = realization.edge_alive
    leaves = jax.tree_util.tree_leaves(params)
    m = leaves[0].shape[0]
    args = (k_sel, topo_arrays.nbrs, topo_arrays.valid, topo_arrays.t, comm)
    if cfg.exchange != "dense":
        from repro.core.gossip import systematic_offsets

        k = max(2, int(round(1.0 / cfg.p)))
        offsets = [to_t(systematic_offsets(jax.random.fold_in(k_mask, idx), m, k))
                   for idx in range(len(leaves))]
        return {"a": to_t(jpme.sample_neighbor_selection(*args, survivors=survivors)),
                "offsets": offsets}
    if cfg.partition == "tree":
        rates = jpme.leaf_rates(len(leaves), cfg.p, cfg.p_leaf)
    else:
        rates = (cfg.p,) * len(leaves)
    masks = []
    for idx, (leaf, p_i) in enumerate(zip(leaves, rates)):
        lkey = jax.random.fold_in(k_mask, idx)
        if cfg.mask_mode == "exact":
            n = int(np.prod(leaf.shape[1:]))
            mk = jpme.sample_coordinate_masks(
                lkey, m, n, max(1, int(round(p_i * n))), mode="exact")
        else:
            mk = jax.random.bernoulli(lkey, p_i, leaf.shape)
        masks.append(to_t(mk))
    if cfg.mixing == "sparse":
        return {"sel": to_t(jpme.sample_neighbor_selection_padded(*args, survivors=survivors)),
                "masks": masks}
    return {"a": to_t(jpme.sample_neighbor_selection(*args, survivors=survivors)),
            "masks": masks}


# the history keys every driver of the reference reports: per-step series
# and run counters (`wire_bits_*` where the registry accounts them)
HISTORY_SERIES = ("loss", "objective", "consensus")
HISTORY_COUNTS = ("steps_run", "steps_dispatched")


def assert_history_matches(got, want, rtol=1e-5, atol=1e-5):
    """A port run's history dict against the reference's, over the
    reference's keys: the per-step series at (rtol, atol), the run counters
    exactly, the registry's `wire_bits_*` at rtol."""
    for k in HISTORY_SERIES:
        if len(want.get(k, ())):
            assert len(got[k]) == len(want[k]), k
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64),
                                       rtol=rtol, atol=atol, err_msg=k)
    for k in HISTORY_COUNTS:
        if k in want:
            assert int(got[k]) == int(want[k]), k
    for k in ("wire_bits_per_step", "wire_bits_total"):
        if k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# dynamic networks: the uniforms behind JAX's scenario, temporal and fault
# draws, in the port's ``u=`` format
# ---------------------------------------------------------------------------
def jax_scenario_draws(arrays, k):
    """The uniforms `repro.core.scenarios.sample_masks` reads at step k
    (edge per undirected link, node, straggler), from split(fold_in(key,
    k), 3); `jax.random.bernoulli(key, p)` is ``uniform(key) < p``."""
    from repro.core.scenarios import edge_uniform

    m = arrays.nbrs.shape[0]
    k_edge, k_node, k_strag = jax.random.split(jax.random.fold_in(arrays.key, k), 3)
    return {"edge": to_t(edge_uniform(k_edge, arrays.nbrs)),
            "node": to_t(jax.random.uniform(k_node, (m,))),
            "strag": to_t(jax.random.uniform(k_strag, (m,)))}


def jax_temporal_draws(scenario, arrays, k):
    """The uniforms `repro.core.temporal.advance` reads at step k (the
    scenario's three streams, and the mobility epoch's per-link draw)."""
    from repro.core import temporal as jtemp
    from repro.core.scenarios import edge_uniform

    u = jax_scenario_draws(arrays, k)
    if scenario.mobile:
        epoch = k // scenario.resample_every
        k_mob = jax.random.fold_in(jax.random.fold_in(arrays.key, jtemp._MOBILITY_FOLD), epoch)
        u["mobility"] = to_t(edge_uniform(k_mob, arrays.nbrs))
    return u


def jax_temporal_init_draws(arrays):
    """The stationary initial draws of `temporal_state_init`."""
    from repro.core import temporal as jtemp
    from repro.core.scenarios import edge_uniform

    m = arrays.nbrs.shape[0]
    fold = lambda c: jax.random.fold_in(arrays.key, c)  # noqa: E731
    return {"edge": to_t(edge_uniform(fold(jtemp._INIT_EDGE_FOLD), arrays.nbrs)),
            "node": to_t(jax.random.uniform(fold(jtemp._INIT_NODE_FOLD), (m,))),
            "strag": to_t(jax.random.uniform(fold(jtemp._INIT_STRAG_FOLD), (m,)))}


def jax_fault_draws(key, k, m, d):
    """The uniforms `repro.core.faults.advance_faults` reads at step k,
    from split(fold_in(key, k), 4): loss, burst, crash, delay."""
    k_loss, k_burst, k_crash, k_delay = jax.random.split(jax.random.fold_in(key, k), 4)
    return {"loss": to_t(jax.random.uniform(k_loss, (m, d))),
            "burst": to_t(jax.random.uniform(k_burst, (m, d))),
            "crash": to_t(jax.random.uniform(k_crash, (m,))),
            "delay": to_t(jax.random.uniform(k_delay, (m,)))}


def jax_fault_init_draws(key, m, d):
    from repro.core import faults as jflt

    return {"link": to_t(jax.random.uniform(jax.random.fold_in(key, jflt._INIT_LINK_FOLD),
                                            (m, d)))}


def _close(got, want, rtol, atol, msg):
    np.testing.assert_allclose(to_np(got).astype(np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol, err_msg=msg)


def jax_pacing_draws(pacing, es, k):
    """The draws `repro.serve.events.ServePacing.advance` makes at round k
    from the event clock `es`: the burst chain's uniforms, from
    split(fold_in(key, k))[0], and the round's Poisson arrivals (read off
    the JAX clock's cumulative count)."""
    k_mod, _ = jax.random.split(jax.random.fold_in(es.key, jnp.asarray(k, jnp.int32)))
    new_es = pacing.advance(es, jnp.asarray(k, jnp.int32))[0]
    return {"mod": to_t(jax.random.uniform(k_mod, (es.queue.shape[0],))),
            "arrivals": to_t(np.asarray(new_es.arrived) - np.asarray(es.arrived))}


def bound_parity(name, jbound, tbound, jstacked, tstacked, jbatch, tbatch, steps,
                 rtol=1e-5, atol=1e-6, key=None, tkey=0):
    """`steps` bound steps of JAX's and the port's `BoundAlgorithm` (static,
    dynamic, temporal, faulty or paced) from the same stacked parameters,
    with JAX's network draws (scenario, temporal, fault uniforms,
    stationary initial draws, the event clock's draws) and the algorithm's
    own draws (PaME's realized selection and masks, the baselines'
    compression uniforms) injected into the port.  After each step every
    state leaf and every metric the JAX step reports are compared (rtol,
    atol), and a paced bind's event clocks exactly.  Returns the per-step
    (JAX metrics, port metrics)."""
    from repro.core import faults as jflt
    from repro.core import scenarios as jscen
    from repro.core import temporal as jtemp

    key = jax.random.PRNGKey(0) if key is None else key
    sj = jbound.init(key, jstacked, jbatch)
    st = tbound.init(tkey, tstacked, tbatch)
    arr = jbound.scen_arrays
    paced = getattr(jbound, "paced", False)
    aj = at = None
    if jbound.carries_aux:
        aj = jbound.aux_init(sj)
        d = arr.nbrs.shape[1]
        u0 = (jax_fault_init_draws(jbound.fault_key, arr.m, d) if jbound.faulty
              else None if paced else jax_temporal_init_draws(arr))
        at = tbound.aux_init(st, u=u0)
    out = []
    for k in range(steps):
        draws, jr, busy = {}, None, None
        kk = jnp.asarray(k, jnp.int32)
        if paced:
            draws["pacing"] = jax_pacing_draws(jbound.pacing, aj.events, k)
            busy = jbound.pacing.advance(aj.events, kk)[1]
        if jbound.faulty:
            draws["scenario"] = jax_scenario_draws(arr, k)
            draws["faults"] = jax_fault_draws(jbound.fault_key, k, arr.m, arr.nbrs.shape[1])
            edge_up, alive, strag = jscen.sample_masks(jbound.scenario, arr, kk)
            if busy is not None:
                strag = strag | busy
            fs = (aj.inner if paced else aj).fs
            jr = jflt.advance_faults(jbound.faults, arr, fs, jbound.fault_key, kk,
                                     edge_up, alive, strag)[1].base
        elif jbound.temporal:
            draws["temporal"] = jax_temporal_draws(jbound.scenario, arr, k)
            jr = jtemp.advance(jbound.scenario, arr, aj.ts, kk)[1]
        elif jbound.dynamic:
            draws["scenario"] = jax_scenario_draws(arr, k)
            edge_up, alive, strag = jscen.sample_masks(jbound.scenario, arr, kk)
            if busy is not None:
                strag = strag | busy
            jr = jscen.realization_from_masks(arr, edge_up, alive, strag)
        if name == "pame":
            draws["algo"] = jax_step_draws(sj.key, int(sj.step), sj.params,
                                           jbound.ctx.extras["topo_arrays"], jbound.ctx.hps,
                                           realization=jr)
        else:
            draws["algo"] = jax_compression_draws(name, key, k, sj.params) or None
        if jbound.carries_aux:
            sj, mj, aj = jbound.step(sj, jbatch, kk, aj)
            st, mt, at = tbound.step(st, tbatch, k, at, draws=draws)
        elif jbound.dynamic:
            sj, mj = jbound.step(sj, jbatch, kk)
            st, mt = tbound.step(st, tbatch, k, draws=draws)
        else:
            sj, mj = jbound.step(sj, jbatch)
            st, mt = tbound.step(st, tbatch, draws=draws)
        for field in sj._fields:
            if field in ("step", "key"):
                continue
            for g, w in zip(jax.tree_util.tree_leaves(getattr(st, field)),
                            jax.tree_util.tree_leaves(getattr(sj, field))):
                _close(g, w, rtol, atol, f"{name} step {k} {field}")
        for mk, w in mj.items():
            assert mk in mt, f"{name} step {k}: metric {mk} missing"
            _close(torch.as_tensor(mt[mk]), w, max(rtol, 1e-5), max(atol, 1e-5),
                   f"{name} step {k} metric {mk}")
        if paced:
            for field in ("hi", "queue", "arrived", "served", "wait"):
                np.testing.assert_array_equal(to_np(getattr(at.events, field)),
                                              np.asarray(getattr(aj.events, field)),
                                              err_msg=f"{name} step {k} events.{field}")
        out.append((mj, mt))
    return out


# ---------------------------------------------------------------------------
# fixtures shared by the dynamic-network suites (tests/test_torch_scenarios.py,
# test_torch_temporal.py, test_torch_faults.py)
# ---------------------------------------------------------------------------
ALL = ("pame", "dpsgd", "dfedsam", "choco", "beer", "anq_nids")
M, N, SPN = 8, 30, 32


def _regression():
    """tests/test_baselines.py's linear regression, distinct node models."""
    rng = np.random.default_rng(0)
    w_star = rng.standard_normal(N)
    a = rng.standard_normal((M, SPN, N))
    y = a @ w_star + 0.1 * rng.standard_normal((M, SPN))
    return (a.astype(np.float32), y.astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


A_NP, Y_NP, W0_NP = _regression()
JB = (jnp.asarray(A_NP), jnp.asarray(Y_NP))


def TB_():
    return torch.as_tensor(A_NP), torch.as_tensor(Y_NP)


def j_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * jnp.mean(r ** 2), aa.T @ r / aa.shape[0]


def t_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * torch.mean(r ** 2), aa.T @ r / aa.shape[0]


def _pair(kind, m, kw):
    from repro.core.topology import build_topology as jbuild
    from repro_torch.core.topology import build_topology as tbuild

    return jbuild(kind, m, **kw), tbuild(kind, m, **kw)


def hps(mod, name):
    """Small-problem hyperparameters of tests/test_torch_baselines.py, for
    either registry module."""
    return {
        "pame": mod.PaMEHp(nu=0.5, p=0.3, gamma=1.01, sigma0=8.0, mask_mode="bernoulli"),
        "dpsgd": mod.DPSGDHp(lr=0.05),
        "dfedsam": mod.DFedSAMHp(lr=0.05, rho=0.01),
        "choco": mod.ChocoHp(lr=0.05, gossip_gamma=0.3, comp_frac=0.3),
        "beer": mod.BeerHp(lr=0.02, gossip_gamma=0.3, comp_frac=0.3),
        "anq_nids": mod.AnqNidsHp(lr=0.05, qsgd_levels=64),
    }[name]


def binds(name, jkw, tkw, mixing="sparse", topo=("erdos_renyi", M, {"p": 0.6, "seed": 1})):
    """(JAX bound, port bound) of `name` on the regression fixture."""
    from repro.core import algorithms as JALG
    from repro_torch.core import algorithms as TALG

    tj, tt = _pair(*topo)
    bj = JALG.get_algorithm(name).bind(j_grad, tj, hps(JALG, name), mixing=mixing, **jkw)
    bt = TALG.get_algorithm(name).bind(t_grad, tt, hps(TALG, name), mixing=mixing,
                                       device="cpu", **tkw)
    return bj, bt


def lm_setup():
    """(JAX stacked params, tokens, JAX grad_fn, port grad_fn) of the
    1-layer f32 smoke LM on 4 nodes."""
    from repro.configs import get_config as jget_config
    from repro.models.model import init_params as jinit, train_loss as jloss
    from repro_torch.configs import get_config
    from repro_torch.models.model import train_loss
    from repro_torch.tree import tree_flatten, tree_unflatten

    cfg_j = jget_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    cfg_t = get_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    stacked = jax.vmap(lambda k: jinit(k, cfg_j))(jax.random.split(jax.random.PRNGKey(0), 4))
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (4, 1, 16)).astype(np.int32)

    def jg(p, b, k):
        return jax.value_and_grad(lambda pp: jloss(pp, cfg_j, b))(p)

    def tg(p, b, k):
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg_t, b)
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))

    return stacked, toks, jg, tg


def lm_binds(name, lm, jkw, tkw):
    """(JAX bound, port bound, JAX stack, port stack, JAX batch, port batch)
    of `name` on the smoke LM (PaME with the trainer's hyperparameters)."""
    import dataclasses

    from repro.core import algorithms as JALG
    from repro_torch import convert
    from repro_torch.core import algorithms as TALG

    stacked, toks, jg, tg = lm
    tj, tt = _pair("erdos_renyi", 4, {"p": 0.5, "seed": 0})
    hj = JALG.PaMEHp(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, mask_mode="bernoulli") \
        if name == "pame" else hps(JALG, name)
    ht = TALG.PaMEHp(**dataclasses.asdict(hj)) if name == "pame" else hps(TALG, name)
    bj = JALG.get_algorithm(name).bind(jg, tj, hj, **jkw)
    bt = TALG.get_algorithm(name).bind(tg, tt, ht, device="cpu", **tkw)
    return (bj, bt, stacked, convert.to_torch(jax.device_get(stacked)),
            {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)})


def inv_hps(name):
    """tests/test_invariants.py's hyperparameters (2^20 QSGD levels put the
    quantizer's error below f32 resolution)."""
    from repro_torch.core import algorithms as TALG

    return {
        "pame": TALG.PaMEHp(nu=0.5, p=0.3, gamma=1.01, sigma0=8.0),
        "dpsgd": TALG.DPSGDHp(lr=0.1),
        "dfedsam": TALG.DFedSAMHp(lr=0.1, rho=0.01),
        "choco": TALG.ChocoHp(lr=0.05, gossip_gamma=0.3, comp_frac=0.3),
        "beer": TALG.BeerHp(lr=0.05, gossip_gamma=0.3, comp_frac=0.3),
        "anq_nids": TALG.AnqNidsHp(lr=0.1, qsgd_levels=1 << 20),
    }[name]


def inv_atol(name):
    return 1e-4 if name == "anq_nids" else 2e-6


def zero_grad(p, b, k):
    return torch.zeros(()), {kk: torch.zeros_like(v) for kk, v in p.items()}


def inv_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.standard_normal((4, 3)).astype(np.float32)),
            "b": torch.as_tensor(rng.standard_normal(5).astype(np.float32))}


def inv_batch():
    return {"x": torch.zeros((M, 2))}


def check_fixed_point(name, bound, state, params0, per_node):
    """tests/test_invariants.py's `_check_fixed_point`: the global mean at
    the initial point, and every node there for `per_node` algorithms."""
    out = bound.params_of(state)
    for key, ref in params0.items():
        assert out[key].dtype == ref.dtype and out[key].shape == (M,) + tuple(ref.shape)
        torch.testing.assert_close(out[key].mean(dim=0), ref, rtol=0,
                                   atol=max(inv_atol(name), 5e-6))
        if name in per_node:
            torch.testing.assert_close(out[key], ref.expand_as(out[key]), rtol=0,
                                       atol=inv_atol(name))


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch's intra-op threads at 1 for a module of small CPU runs, restored
    after: the suite runs several workers at once, and OpenMP threads that
    wait on each other across busy cores made the smoke CLI runs 10-30x
    slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
