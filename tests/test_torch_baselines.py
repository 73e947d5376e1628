"""The five baselines of the port against the JAX package, with JAX's
compression draws injected: every state tree after each of four steps, in
f32, on the linear-regression fixture of tests/test_baselines.py (1e-5)
and on a tiny stablelm-shaped LM (1e-4, the LM's forward / backward in
another framework); the port's own convergence runs (loss < 0.05 × the
initial one, as the JAX tests ask); mean preservation of D-PSGD and NIDS
on a doubly stochastic B; the registry's wire bits against JAX's for all
six algorithms; the drivers and the stop rule with steps that update
their state in place."""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core import algorithms as JALG
from repro.core import baselines as JB
from repro.core import compression as jc
from repro.core import mixing as jmix
from repro.core.topology import build_topology as jbuild
from repro.models.model import init_params as jinit, train_loss as jloss
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import algorithms as TALG
from repro_torch.core import baselines as TB
from repro_torch.core import compression as tc
from repro_torch.core import mixing as tmix
from repro_torch.core.topology import build_topology as tbuild
from repro_torch.models.model import train_loss
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

from _torch_parity import jax_compression_draws, to_np

NAMES = ("dpsgd", "dfedsam", "choco", "beer", "anq_nids")
M, N, SPN = 8, 30, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run hundreds of tiny torch ops a step.  With several test
    workers on one host, torch's intra-op threads only wait on each other
    (the parity rehearsal took 5.6 s alone and 346 s beside five other
    workers), so each test runs torch on one thread and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _steps(name, jm, tm):
    """(jax step, port step) for `name` with the small-problem
    hyperparameters of tests/test_baselines.py."""
    if name == "dpsgd":
        return (lambda s, b, g: JB.dpsgd_step(s, b, g, jm, 0.05),
                lambda s, b, g, d: TB.dpsgd_step(s, b, g, tm, 0.05, draws=d))
    if name == "dfedsam":
        return (lambda s, b, g: JB.dfedsam_step(s, b, g, jm, 0.05, rho=0.01, local_steps=2),
                lambda s, b, g, d: TB.dfedsam_step(s, b, g, tm, 0.05, rho=0.01, local_steps=2,
                                                   draws=d))
    if name == "choco":
        return (lambda s, b, g: JB.choco_step(s, b, g, jm, 0.05, jc.rand_k(0.3, rescale=False), 0.3),
                lambda s, b, g, d: TB.choco_step(s, b, g, tm, 0.05, tc.rand_k(0.3, rescale=False),
                                                 0.3, draws=d))
    if name == "beer":
        return (lambda s, b, g: JB.beer_step(s, b, g, jm, 0.02, jc.rand_k(0.3, rescale=False), 0.3),
                lambda s, b, g, d: TB.beer_step(s, b, g, tm, 0.02, tc.rand_k(0.3, rescale=False),
                                                0.3, draws=d))
    return (lambda s, b, g: JB.nids_step(s, b, g, jm, 0.05, jc.qsgd(64)),
            lambda s, b, g, d: TB.nids_step(s, b, g, tm, 0.05, tc.qsgd(64), draws=d))


def _inits(name, key, jstacked, tstacked, jbatch, tbatch, jgrad, tgrad):
    if name == "beer":
        return (JB.beer_init(key, jstacked, jbatch, jgrad),
                TB.beer_init(0, tstacked, tbatch, tgrad))
    init = {"dpsgd": (JB.dpsgd_init, TB.dpsgd_init), "dfedsam": (JB.dfedsam_init, TB.dfedsam_init),
            "choco": (JB.choco_init, TB.choco_init), "anq_nids": (JB.nids_init, TB.nids_init)}
    ji, ti = init[name]
    return ji(key, jstacked), ti(0, tstacked)


def _state_trees(state):
    """The tensor fields of a baseline state, in field order."""
    return [getattr(state, f) for f in state._fields if f not in ("step", "key")]


def _from_jax(sj, like):
    """The port's state holding JAX state `sj`'s values."""
    return type(like)(*[
        int(getattr(sj, f)) if f == "step" else like.key if f == "key"
        else convert.to_torch(jax.device_get(getattr(sj, f)))
        for f in like._fields
    ])


def _run_parity(name, mode, jgrad, tgrad, jstacked, tstacked, jbatch, tbatch, topo_args, atol,
                steps=4, step_by_step=False, max_off=0):
    """`steps` steps of JAX and the port with JAX's draws injected, every
    state tree compared after each.  step_by_step=True advances JAX with its
    scan driver one step per call and restarts the port from JAX's state
    before every step; up to `max_off` coordinates a step may then exceed
    `atol` (QSGD level flips: see test_lm_steps_match_jax)."""
    kind, m, kw = topo_args
    jm = jmix.make_mixer(jbuild(kind, m, **kw), mode, impl=None if mode == "matrix" else "slots")
    tm = tmix.make_mixer(tbuild(kind, m, **kw), mode, impl=None if mode == "matrix" else "slots")
    key = jax.random.PRNGKey(0)
    sj, st = _inits(name, key, jstacked, tstacked, jbatch, tbatch, jgrad, tgrad)
    jraw, tstep = _steps(name, jm, tm)
    jstep = jax.jit(lambda s, b: jraw(s, b, jgrad))
    for k in range(steps):
        draws = jax_compression_draws(name, key, k, sj.params)
        if step_by_step:
            st = _from_jax(sj, st)
            sj, hist = JB.run_algorithm(lambda s, b: jraw(s, b, jgrad), sj, lambda _: jbatch, 1,
                                        tol_std=0.0, driver="scan", chunk_size=1)
            j_loss = hist["loss"][0]
        else:
            sj, mj = jstep(sj, jbatch)
            j_loss = float(mj["loss_mean"])
        st, mt = tstep(st, tbatch, tgrad, draws or None)
        assert st.step == k + 1
        np.testing.assert_allclose(float(mt["loss_mean"]), j_loss, rtol=1e-5)
        off = 0
        for field, tt, jt in zip(sj._fields, _state_trees(st), _state_trees(sj)):
            for g, w in zip(tree_leaves(tt), jax.tree_util.tree_leaves(jt)):
                diff = np.abs(to_np(g) - np.asarray(w))
                if max_off:
                    off += int((diff > atol).sum())
                else:
                    np.testing.assert_allclose(to_np(g), np.asarray(w), atol=atol,
                                               err_msg=f"{name} step {k} {field}")
        assert off <= max_off, f"{name} step {k}: {off} coordinates beyond {atol}"


# ---------------------------------------------------------------------------
# linear regression (tests/test_baselines.py's fixture, distinct node models)
# ---------------------------------------------------------------------------
def _regression():
    rng = np.random.default_rng(0)
    w_star = rng.standard_normal(N)
    a = rng.standard_normal((M, SPN, N))
    y = a @ w_star + 0.1 * rng.standard_normal((M, SPN))
    w0 = rng.standard_normal((M, N))
    return a.astype(np.float32), y.astype(np.float32), w0.astype(np.float32)


A_NP, Y_NP, W0_NP = _regression()
REG_TOPO = ("erdos_renyi", M, {"p": 0.6, "seed": 1})


def j_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * jnp.mean(r ** 2), aa.T @ r / aa.shape[0]


def t_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * torch.mean(r ** 2), aa.T @ r / aa.shape[0]


@pytest.mark.parametrize("mode", ["matrix", "sparse"])
@pytest.mark.parametrize("name", NAMES)
def test_regression_steps_match_jax(name, mode):
    _run_parity(name, mode, j_grad, t_grad, jnp.asarray(W0_NP), torch.tensor(W0_NP),
                (jnp.asarray(A_NP), jnp.asarray(Y_NP)),
                (torch.as_tensor(A_NP), torch.as_tensor(Y_NP)), REG_TOPO, atol=1e-5)


@pytest.mark.parametrize("comp", ["rand_k", "qsgd"])
def test_compress_tree_matches_jax(comp):
    """`_compress_tree` per leaf and per node row, with the uniforms JAX
    draws from fold_in(key, leaf) injected."""
    tree = {"w": W0_NP, "b": [A_NP[:, 0], Y_NP]}
    key = jax.random.PRNGKey(5)
    jcomp = jc.rand_k(0.3, rescale=False) if comp == "rand_k" else jc.qsgd(16)
    tcomp = tc.rand_k(0.3, rescale=False) if comp == "rand_k" else tc.qsgd(16)
    want = JB._compress_tree(jcomp, key, jax.tree_util.tree_map(jnp.asarray, tree))
    draws = [torch.as_tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, idx), (leaf.shape[0], int(np.prod(leaf.shape[1:]))))))
        for idx, leaf in enumerate(jax.tree_util.tree_leaves(tree))]
    got = TB._compress_tree(tcomp, 0, convert.to_torch(tree), draws=draws)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)
    own = TB._compress_tree(tcomp, 3, convert.to_torch(tree))
    assert [tuple(x.shape) for x in tree_leaves(own)] == [w.shape for w in
                                                          jax.tree_util.tree_leaves(want)]


def test_nids_without_compression_matches_jax():
    jm = jmix.make_mixer(jbuild(*REG_TOPO[:2], **REG_TOPO[2]), "sparse", impl="slots")
    tm = tmix.make_mixer(tbuild(*REG_TOPO[:2], **REG_TOPO[2]), "sparse", impl="slots")
    sj = JB.nids_init(jax.random.PRNGKey(0), jnp.asarray(W0_NP))
    st = TB.nids_init(0, torch.tensor(W0_NP))
    step = jax.jit(lambda s, b: JB.nids_step(s, b, j_grad, jm, 0.05))
    jb, tb = (jnp.asarray(A_NP), jnp.asarray(Y_NP)), (torch.as_tensor(A_NP), torch.as_tensor(Y_NP))
    for _ in range(4):
        sj, _ = step(sj, jb)
        st, _ = TB.nids_step(st, tb, t_grad, tm, 0.05)
        for tt, jt in zip(_state_trees(st), _state_trees(sj)):
            np.testing.assert_allclose(to_np(tt), np.asarray(jt), atol=1e-5)


# ---------------------------------------------------------------------------
# a tiny stablelm-shaped LM (the smoke config cut to 1 layer: d_model 256, f32)
# ---------------------------------------------------------------------------
LM_M = 4


@pytest.fixture(scope="module")
def lm():
    cfg_j = jget_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    cfg_t = get_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    assert cfg_j.dtype == "float32"
    stacked = jax.vmap(lambda k: jinit(k, cfg_j))(jax.random.split(jax.random.PRNGKey(0), LM_M))
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (LM_M, 1, 16)).astype(np.int32)

    def jg(p, b, k):
        return jax.value_and_grad(lambda pp: jloss(pp, cfg_j, b))(p)

    def tg(p, b, k):
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg_t, b)
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))

    return cfg_j, stacked, toks, jg, tg


@pytest.mark.parametrize("name", NAMES)
def test_lm_steps_match_jax(name, lm):
    """3 steps on the LM with sparse mixing, to 1e-4.  ANQ-NIDS is held step
    by step against JAX's scan driver (its scan and host drivers split:
    ROADMAP queue 3).  QSGD compares each uniform with a probability taken
    from the state, and the LM gradients of the two frameworks differ in
    the last f32 bits, so a uniform within ~1e-6 of its probability lands
    one level apart.  Each such flip moves one coordinate of ẑ and ĉ and
    that coordinate of x at up to 3 receivers; on this input one flip (5
    coordinates) in step 2, none before (the 2-layer LM showed 6 and 5
    flips in steps 1 and 2).  So at most 64 of the 12.6 M state
    coordinates a step may exceed 1e-4."""
    _, stacked, toks, jg, tg = lm
    tstacked = convert.to_torch(jax.device_get(stacked))
    nids = name == "anq_nids"
    _run_parity(name, "sparse", jg, tg, stacked, tstacked,
                {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)},
                ("erdos_renyi", LM_M, {"p": 0.5, "seed": 0}), atol=1e-4, steps=3,
                step_by_step=nids, max_off=64 if nids else 0)


def test_anq_nids_step_by_step_against_jax_scan_driver():
    """ANQ-NIDS on the regression fixture, held step by step against JAX's
    scan driver, to 1e-5 with no coordinate off."""
    _run_parity("anq_nids", "sparse", j_grad, t_grad, jnp.asarray(W0_NP),
                torch.tensor(W0_NP), (jnp.asarray(A_NP), jnp.asarray(Y_NP)),
                (torch.as_tensor(A_NP), torch.as_tensor(Y_NP)), REG_TOPO, atol=1e-5,
                step_by_step=True)


# ---------------------------------------------------------------------------
# the port's own behaviour
# ---------------------------------------------------------------------------
def _t_problem():
    return (tmix.make_mixer(tbuild(*REG_TOPO[:2], **REG_TOPO[2]), "sparse"),
            (torch.as_tensor(A_NP), torch.as_tensor(Y_NP)))


def _t_run(step_fn, state, batch, steps):
    _, hist = TB.run_algorithm(step_fn, state, lambda k: batch, steps, tol_std=0.0)
    return hist["loss"]


@pytest.mark.parametrize("name,steps", [("dpsgd", 250), ("dfedsam", 250), ("choco", 400),
                                        ("beer", 400), ("nids", 250), ("anq_nids", 400)])
def test_convergence(name, steps):
    """tests/test_baselines.py's runs on the port, from zero weights."""
    mx, batch = _t_problem()
    w0 = TB.stack_params(torch.zeros(N), M)
    comp = tc.rand_k(0.3, rescale=False)
    st, fn = {
        "dpsgd": (TB.dpsgd_init(0, w0), lambda s, b: TB.dpsgd_step(s, b, t_grad, mx, 0.05)),
        "dfedsam": (TB.dfedsam_init(0, w0),
                    lambda s, b: TB.dfedsam_step(s, b, t_grad, mx, 0.05, rho=0.01)),
        "choco": (TB.choco_init(0, w0), lambda s, b: TB.choco_step(s, b, t_grad, mx, 0.05, comp, 0.3)),
        "beer": (TB.beer_init(0, w0, batch, t_grad),
                 lambda s, b: TB.beer_step(s, b, t_grad, mx, 0.02, comp, 0.3)),
        "nids": (TB.nids_init(0, w0), lambda s, b: TB.nids_step(s, b, t_grad, mx, 0.05)),
        "anq_nids": (TB.nids_init(0, w0),
                     lambda s, b: TB.nids_step(s, b, t_grad, mx, 0.05, tc.qsgd(64))),
    }[name]
    loss = _t_run(fn, st, batch, steps)
    assert loss[-1] < (0.1 if name == "anq_nids" else 0.05) * loss[0]


@pytest.mark.parametrize("name", ["dpsgd", "nids"])
def test_mean_preservation(name):
    """On a doubly stochastic B, the node mean moves by −lr · mean gradient
    only: D-PSGD's mixing and NIDS's (Ã − I) correction preserve it."""
    topo = tbuild(*REG_TOPO[:2], **REG_TOPO[2])
    nbrs, w_pad, is_self = (torch.as_tensor(v) for v in topo.mixing_padded())
    b64 = torch.as_tensor(topo.mixing)
    w64 = torch.where(w_pad != 0, b64[nbrs.long(), torch.arange(M)[:, None]], 0.0)
    mx = tmix.Mixer("sparse", b64, tmix.PaddedMixing(nbrs, w64, is_self), "slots")
    w = torch.as_tensor(W0_NP).double()
    batch = (torch.as_tensor(A_NP).double(), torch.as_tensor(Y_NP).double())
    st = TB.dpsgd_init(0, w.clone()) if name == "dpsgd" else TB.nids_init(0, w.clone())
    for _ in range(5):
        before = st.params.mean(dim=0)
        grads = torch.stack([t_grad(st.params[i], (batch[0][i], batch[1][i]), 0)[1]
                             for i in range(M)])
        if name == "dpsgd":
            st, _ = TB.dpsgd_step(st, batch, t_grad, mx, 0.05)
        else:
            st, _ = TB.nids_step(st, batch, t_grad, mx, 0.05)
        torch.testing.assert_close(st.params.mean(dim=0), before - 0.05 * grads.mean(dim=0),
                                   rtol=0, atol=1e-12)


def test_stack_params_and_state_fields_have_distinct_storage():
    mx, batch = _t_problem()
    w0 = TB.stack_params(torch.zeros(N), M)
    assert w0.shape == (M, N) and w0.stride(0) == N
    st = TB.beer_init(0, w0, batch, t_grad)
    ptrs = [t.data_ptr() for t in _state_trees(st)]
    assert len(set(ptrs)) == len(ptrs)
    st = TB.nids_init(0, w0)
    ptrs = [t.data_ptr() for t in _state_trees(st)]
    assert len(set(ptrs)) == len(ptrs)


def test_grad_shift_raises():
    """A grad_shift whose leaves do not match the parameters' raises; a
    matching one (JAX's tree form, or the rows of the shifted nodes only)
    moves each gradient point as JAX's `_shifted` does."""
    mx, batch = _t_problem()
    st = TB.dpsgd_init(0, TB.stack_params(torch.zeros(N), M))
    with pytest.raises(ValueError, match="grad_shift"):
        TB.dpsgd_step(st, batch, t_grad, mx, 0.05, grad_shift=[st.params, st.params])
    shift = np.zeros((M, N), np.float32)
    shift[[1, 5]] = np.random.default_rng(7).standard_normal((2, N)).astype(np.float32)
    jm = jmix.make_mixer(jbuild(*REG_TOPO[:2], **REG_TOPO[2]), "sparse", impl="slots")
    want, _ = JB.dpsgd_step(JB.dpsgd_init(jax.random.PRNGKey(0), jnp.asarray(W0_NP)),
                            (jnp.asarray(A_NP), jnp.asarray(Y_NP)), j_grad, jm, 0.05,
                            grad_shift=jnp.asarray(shift))
    rows = TB.GradShift({i: [torch.as_tensor(shift[i])] for i in (1, 5)})
    for gs in (torch.as_tensor(shift), rows):
        got, _ = TB.dpsgd_step(TB.dpsgd_init(0, torch.tensor(W0_NP)), batch, t_grad,
                               tmix.make_mixer(tbuild(*REG_TOPO[:2], **REG_TOPO[2]), "sparse",
                                               impl="slots"), 0.05, grad_shift=gs)
        np.testing.assert_allclose(to_np(got.params), np.asarray(want.params), atol=1e-6)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def _hps(mod, name):
    return {
        "pame": mod.PaMEHp(nu=0.3, p=0.3, gamma=1.01, sigma0=8.0),
        "dpsgd": mod.DPSGDHp(lr=0.05),
        "dfedsam": mod.DFedSAMHp(lr=0.05, rho=0.01),
        "choco": mod.ChocoHp(lr=0.05, gossip_gamma=0.3, comp_frac=0.3),
        "beer": mod.BeerHp(lr=0.02, gossip_gamma=0.3, comp_frac=0.3),
        "anq_nids": mod.AnqNidsHp(lr=0.05, qsgd_levels=64),
    }[name]


ALL = ("pame",) + NAMES


def test_registry_lists_all_six():
    assert TALG.list_algorithms() == JALG.list_algorithms() == ALL


@pytest.mark.parametrize("name", ALL)
def test_wire_bits_match_jax(name):
    topo_j, topo_t = jbuild(*REG_TOPO[:2], **REG_TOPO[2]), tbuild(*REG_TOPO[:2], **REG_TOPO[2])
    for hj in (JALG.get_algorithm(name).hp_cls(), _hps(JALG, name)):
        ht = TALG.get_algorithm(name).hp_cls(**dataclasses.asdict(hj))
        bj = JALG.get_algorithm(name).bind(j_grad, topo_j, hj)
        bt = TALG.get_algorithm(name).bind(t_grad, topo_t, ht, device="cpu")
        for n in (1, 30, 4097, 1_438_746_624):
            assert bt.wire_bits(n) == bj.wire_bits(n)
        tree = {"a": np.zeros((3, 5), np.float32), "b": [np.zeros(7, np.float32)]}
        assert bt.wire_bits_for(convert.to_torch(tree)) == bj.wire_bits_for(tree)
        spec_j, spec_t = JALG.get_algorithm(name), TALG.get_algorithm(name)
        assert spec_t.needs_batch0 == spec_j.needs_batch0
        assert (spec_t.edge_bits is None) == (spec_j.edge_bits is None)
        if spec_t.edge_bits is not None:
            assert spec_t.edge_bits(ht, 1000) == spec_j.edge_bits(hj, 1000)


@pytest.mark.parametrize("name", ALL)
def test_registry_scan_and_host_drivers_agree(name):
    """The port's two drivers run the same eager steps, so they agree
    exactly; ANQ-NIDS included (the JAX package's two drivers split beyond
    rtol 1e-5 there: tests/test_algorithms.py, ROADMAP queue 3)."""
    topo = tbuild(*REG_TOPO[:2], **REG_TOPO[2])
    bound = TALG.get_algorithm(name).bind(t_grad, topo, _hps(TALG, name), device="cpu")
    assert bound.ctx.mixer.mode == "sparse"
    batch = (torch.as_tensor(A_NP), torch.as_tensor(Y_NP))
    outs = {}
    for driver in ("scan", "host"):
        outs[driver] = bound.run(0, torch.zeros(N), M, lambda k: batch, 8, tol_std=0.0,
                                 driver=driver, chunk_size=4)
    (s_s, h_s), (s_h, h_h) = outs["scan"], outs["host"]
    assert h_s["steps_run"] == h_h["steps_run"] == 8
    assert h_s["loss"] == h_h["loss"]
    torch.testing.assert_close(bound.params_of(s_s), bound.params_of(s_h), rtol=0, atol=0)
    assert h_s["wire_bits_per_step"] == bound.wire_bits(N)


@pytest.mark.parametrize("name", ["dpsgd", "beer", "anq_nids"])
def test_stop_rule_freezes_in_place_steps(name):
    """Steps that update their state in place under the engine's stop rule:
    the returned state is the triggering step's, as the host loop's."""
    topo = tbuild(*REG_TOPO[:2], **REG_TOPO[2])
    bound = TALG.get_algorithm(name).bind(t_grad, topo, _hps(TALG, name), device="cpu")
    batch = (torch.as_tensor(A_NP), torch.as_tensor(Y_NP))
    a_t, y_t = batch

    def objective(w):
        return 0.5 * torch.mean((torch.einsum("msn,n->ms", a_t, w) - y_t) ** 2)

    outs = {}
    for driver in ("scan", "host"):
        outs[driver] = bound.run(0, torch.zeros(N), M, lambda k: batch, 40,
                                 objective_fn=objective, tol_std=0.2, driver=driver,
                                 chunk_size=16)
    (s_s, h_s), (s_h, h_h) = outs["scan"], outs["host"]
    assert 3 <= h_h["steps_run"] < 40
    assert h_s["steps_run"] == h_h["steps_run"]
    assert h_s["steps_dispatched"] == 16 * -(-h_h["steps_run"] // 16)
    torch.testing.assert_close(bound.params_of(s_s), bound.params_of(s_h), rtol=0, atol=0)
    assert s_s.step == s_h.step == h_h["steps_run"]


def test_needs_batch0_and_hp_type_enforced():
    topo = tbuild(*REG_TOPO[:2], **REG_TOPO[2])
    bound = TALG.get_algorithm("beer").bind(t_grad, topo, _hps(TALG, "beer"), device="cpu")
    with pytest.raises(ValueError, match="batch0"):
        bound.init(0, TB.stack_params(torch.zeros(N), M))
    with pytest.raises(TypeError, match="dpsgd expects DPSGDHp"):
        TALG.get_algorithm("dpsgd").bind(t_grad, topo, TALG.BeerHp(), device="cpu")


# ---------------------------------------------------------------------------
# the chip smoke's path-D parity phase, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_path_d_parity_rehearsal(monkeypatch, capsys):
    """`chip_smoke.path_d_parity` at a tiny bf16 size on the CPU.  With the
    kernel route's CPU stand-in replaced by the CUDA kernel's exact
    arithmetic (f32 slots chain, rounded once) every state tree matches to
    0 ulps.  With the dense f32 matmul stand-in, whose sums round the other
    way in a few outputs, one flipped bf16 ulp of a mixed value grows
    through the step's cancellations (B x − lr·g, (B − I)x, and for BEER
    the gradients at the moved x) far past the phase's 1-ulp bound: the
    phase would catch a kernel that rounds differently."""
    from repro_torch.kernels.gossip import ops as gops

    cs = _chip_smoke()
    cfg = get_config("stablelm-1.6b", "smoke").replace(dtype="bfloat16", n_layers=1)
    cpu = torch.device("cpu")

    def kernel_arithmetic(nbrs, terms, pad=None):
        clean = [(w if pad is None else torch.where(pad, torch.zeros_like(w), w), x.float())
                 for w, x in terms]
        return tuple(o.to(x.dtype) for o, (_, x) in
                     zip(tmix._gather_terms_slots(nbrs, clean), terms))

    matmul = cs.path_d_parity(cpu, cfg=cfg, batch=1, seq=8, tol=float("inf"))
    monkeypatch.setattr(gops, "gather_terms_ref", kernel_arithmetic)
    exact = cs.path_d_parity(cpu, cfg=cfg, batch=1, seq=8)
    assert set(exact) == set(matmul) == set(cs.BASELINES)
    for name, row in exact.items():
        assert row["max_bf16_ulps_floored"] == 0.0, name
        assert row["loss_kernel"] == row["loss_plain"]
    assert max(r["max_bf16_ulps_floored"] for r in matmul.values()) > 4 * cs.PARITY_ULPS
    assert '"phase": "parity_d"' in capsys.readouterr().out


def test_tree_flatten_leaves_no_reference_cycles():
    """Flattening and rebuilding a tree creates no reference cycle, so a
    step's leaf lists (and their tensors) are freed as soon as they go out
    of scope, not whenever Python's cyclic collector next runs: at full
    width the difference was ~16 GiB of device memory held in BEER's step."""
    import gc

    tree = {"b": [torch.zeros(3), (torch.ones(2), torch.ones(1))], "a": torch.zeros(4)}
    gc.collect()
    gc.disable()
    try:
        gc.set_debug(gc.DEBUG_SAVEALL)
        for _ in range(3):
            leaves, treedef = tree_flatten(tree)
            tree_unflatten(treedef, [x + 1 for x in leaves])
        del leaves, treedef
        assert gc.collect() == 0
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
