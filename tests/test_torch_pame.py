"""PaME (Algorithm 1) against the JAX package on the paper's Example 1
(linear regression, m = 16, n = 200), with JAX's draws injected: dense and
sparse mixing, exact and Bernoulli masks, to f32 atol 1e-5.  Also the scan
driver against the host driver and the frozen-state stop rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pame as jpame
from repro.core.topology import build_topology as jbuild
from repro.data.synthetic import make_linear_regression
from repro_torch.core import algorithms as talg
from repro_torch.core import pame as tpame
from repro_torch.core.topology import build_topology as tbuild

from _torch_parity import jax_step_draws, to_np

ATOL = 1e-5
M, N = 16, 200
A_NP, B_NP, _ = make_linear_regression(M, 64, N, seed=0)


def j_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * jnp.mean(r ** 2), aa.T @ r / aa.shape[0]


def t_grad(w, batch, key):
    aa, yy = batch
    r = aa @ w - yy
    return 0.5 * torch.mean(r ** 2), aa.T @ r / aa.shape[0]


def j_objective(w):
    r = jnp.einsum("mbn,n->mb", jnp.asarray(A_NP), w) - jnp.asarray(B_NP)
    return jnp.sum(0.5 * jnp.mean(r ** 2, axis=1))


def t_objective(w):
    r = torch.einsum("mbn,n->mb", torch.as_tensor(A_NP), w) - torch.as_tensor(B_NP)
    return torch.sum(0.5 * torch.mean(r ** 2, dim=1))


CFGS = {
    f"{mix}-{mode}": jpame.PaMEConfig(nu=0.3, p=0.2, gamma=1.01, sigma0=8.0,
                                      mask_mode=mode, mixing=mix)
    for mix in ("dense", "sparse") for mode in ("exact", "bernoulli")
}


def _t_cfg(cfg):
    return tpame.PaMEConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(CFGS))
def test_pame_steps_match_jax(name):
    cfg = CFGS[name]
    topo = jbuild("erdos_renyi", M, p=0.4, seed=1)
    ta_j = jpame.make_topology_arrays(topo, cfg, seed=0)
    ta_t = tpame.make_topology_arrays(tbuild("erdos_renyi", M, p=0.4, seed=1), _t_cfg(cfg),
                                      seed=0, device="cpu")
    w0 = np.random.default_rng(7).standard_normal((M, N)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    sj = jpame.pame_init(key, jnp.asarray(w0), M, cfg)
    st = tpame.pame_init(0, torch.as_tensor(w0), M, _t_cfg(cfg))
    batch_j = (jnp.asarray(A_NP), jnp.asarray(B_NP))
    batch_t = (torch.as_tensor(A_NP), torch.as_tensor(B_NP))
    step_j = jax.jit(lambda s, b: jpame.pame_step(s, b, j_grad, ta_j, cfg))
    for k in range(4):  # steps 1..3 mix silent and communicating receivers
        draws = jax_step_draws(key, k, sj.params, ta_j, cfg)
        sj, mj = step_j(sj, batch_j)
        st, mt = tpame.pame_step(st, batch_t, t_grad, ta_t, _t_cfg(cfg), draws=draws)
        np.testing.assert_allclose(to_np(st.params), np.asarray(sj.params), atol=ATOL)
        for key_ in ("loss_mean", "consensus", "comm_nodes", "sigma_mean"):
            np.testing.assert_allclose(float(mt[key_]), float(mj[key_]), rtol=1e-5,
                                       err_msg=key_)


def _draws_fn(cfg):
    topo = jbuild("erdos_renyi", M, p=0.4, seed=1)
    ta_j = jpame.make_topology_arrays(topo, cfg, seed=0)
    params = jnp.zeros((M, N))
    return lambda step: jax_step_draws(jax.random.PRNGKey(0), step, params, ta_j, cfg)


@pytest.mark.parametrize("name", ["dense-exact", "sparse-bernoulli"])
def test_run_pame_matches_jax_and_host(name):
    cfg = CFGS[name]
    jstate, jhist = jpame.run_pame(
        jax.random.PRNGKey(0), jnp.zeros(N), M, j_grad,
        lambda k: (jnp.asarray(A_NP), jnp.asarray(B_NP)), jbuild("erdos_renyi", M, p=0.4, seed=1),
        cfg, num_steps=12, objective_fn=j_objective, tol_std=1e-3, chunk_size=5)
    runs = {
        driver: tpame.run_pame(
            0, torch.zeros(N), M, t_grad,
            lambda k: (torch.as_tensor(A_NP), torch.as_tensor(B_NP)),
            tbuild("erdos_renyi", M, p=0.4, seed=1), _t_cfg(cfg), num_steps=12,
            objective_fn=t_objective, tol_std=1e-3, driver=driver, chunk_size=5,
            device="cpu", draws_fn=_draws_fn(cfg))
        for driver in ("scan", "host")
    }
    for driver, (state, hist) in runs.items():
        assert hist["steps_run"] == jhist["steps_run"], driver
        for k in ("loss", "objective", "consensus"):
            np.testing.assert_allclose(hist[k], jhist[k], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(to_np(state.params), np.asarray(jstate.params), atol=ATOL)
    assert runs["scan"][1]["steps_dispatched"] == jhist["steps_dispatched"]


def test_stop_rule_freezes_triggering_state():
    """A loose tolerance fires the rule at the third step of an 8-step
    chunk: the scan driver must return the state of that step (params,
    sigma and step counter), as the host driver and JAX's scan do."""
    cfg = CFGS["sparse-exact"]
    args = dict(num_steps=8, objective_fn=t_objective, tol_std=1e9, chunk_size=8,
                device="cpu", draws_fn=_draws_fn(cfg))
    common = (0, torch.zeros(N), M, t_grad,
              lambda k: (torch.as_tensor(A_NP), torch.as_tensor(B_NP)),
              tbuild("erdos_renyi", M, p=0.4, seed=1), _t_cfg(cfg))
    s_scan, h_scan = tpame.run_pame(*common, driver="scan", **args)
    s_host, h_host = tpame.run_pame(*common, driver="host", **args)
    assert h_scan["steps_run"] == h_host["steps_run"] == 3
    assert h_scan["steps_dispatched"] == 8
    assert s_scan.step == s_host.step == 3
    torch.testing.assert_close(s_scan.params, s_host.params, rtol=0, atol=0)
    torch.testing.assert_close(s_scan.sigma, s_host.sigma, rtol=0, atol=0)
    jstate, jhist = jpame.run_pame(
        jax.random.PRNGKey(0), jnp.zeros(N), M, j_grad,
        lambda k: (jnp.asarray(A_NP), jnp.asarray(B_NP)), jbuild("erdos_renyi", M, p=0.4, seed=1),
        cfg, num_steps=8, objective_fn=j_objective, tol_std=1e9, chunk_size=8)
    assert jhist["steps_run"] == 3 and int(jstate.step) == 3
    np.testing.assert_allclose(to_np(s_scan.params), np.asarray(jstate.params), atol=ATOL)


def test_registry_bind_and_wire_bits_match_jax():
    from repro.core import algorithms as jalg

    topo_j, topo_t = jbuild("erdos_renyi", M, p=0.4, seed=1), tbuild("erdos_renyi", M, p=0.4, seed=1)
    for part in ("flat", "tree"):
        hj = jalg.PaMEHp(partition=part)
        ht = talg.PaMEHp(partition=part)
        bj = jalg.get_algorithm("pame").bind(j_grad, topo_j, hj)
        bt = talg.get_algorithm("pame").bind(t_grad, topo_t, ht, device="cpu")
        params = {"a": np.zeros((3, 4)), "b": np.zeros(7)}
        tparams = {"a": torch.zeros(3, 4), "b": torch.zeros(7)}
        assert bt.wire_bits_for(tparams) == bj.wire_bits_for(params)
        assert bt.wire_bits(N) == bj.wire_bits(N)
    assert talg.list_algorithms() == ("pame",)
    with pytest.raises(ValueError):
        talg.get_algorithm("dpsgd")
    with pytest.raises(NotImplementedError):
        talg.get_algorithm("pame").bind(t_grad, topo_t, device="cpu", scenario=object())
    # the registry's scan run agrees with the host run
    bound = talg.get_algorithm("pame").bind(t_grad, topo_t, talg.PaMEHp(sigma0=8.0),
                                            device="cpu")
    batch = lambda k: (torch.as_tensor(A_NP), torch.as_tensor(B_NP))
    _, h_scan = bound.run(0, torch.zeros(N), M, batch, 6, tol_std=0.0, chunk_size=4)
    _, h_host = bound.run(0, torch.zeros(N), M, batch, 6, tol_std=0.0, driver="host")
    np.testing.assert_allclose(h_scan["loss"], h_host["loss"], rtol=1e-6)
    assert h_scan["wire_bits_total"] == h_host["wire_bits_total"] > 0


def test_not_ported_options_raise():
    cfg = tpame.PaMEConfig(exchange="compressed")
    ta = tpame.make_topology_arrays(tbuild("ring", 4), cfg, device="cpu")
    st = tpame.pame_init(0, torch.zeros(4, 3), 4, cfg)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpame.pame_step(st, None, t_grad, ta, cfg)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpame.pame_step(st, None, t_grad, ta, tpame.PaMEConfig(), realization=object())
    with pytest.raises(ValueError, match="p_leaf"):
        tpame.PaMEConfig(p_leaf=(0.1,))
