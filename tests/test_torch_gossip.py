"""The compressed PME exchange (`repro_torch.core.gossip`) against the JAX
package's, with JAX's class offsets injected: `_leaf_average` on 2-D,
3-D and 1-D leaves, padded classes (d1 % k ≠ 0), k > d1, int8 payloads and
an isolated receiver, to 1e-6 in f32 and one bf16 ulp in bf16; the
pytree form; and PaME with exchange="compressed" / "compressed_q8" against
JAX's steps (1e-5 on the paper's regression, 1e-4 on the tiny LM) with
its Eq.-(8) wire bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core import algorithms as JALG
from repro.core import gossip as jg
from repro.core import pame as jpame
from repro.core.topology import build_topology as jbuild
from repro.data.synthetic import make_linear_regression
from repro.models.model import init_params as jinit, train_loss as jloss
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import algorithms as TALG
from repro_torch.core import gossip as tg
from repro_torch.core import pame as tpame
from repro_torch.core.topology import build_topology as tbuild
from repro_torch.models.model import train_loss
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

from _torch_parity import jax_step_draws, to_np, to_t


def _sel(m, seed, isolated=1):
    rng = np.random.default_rng(seed)
    a = (rng.random((m, m)) < 0.5) & ~np.eye(m, dtype=bool)
    a[:, isolated] = False  # receiver `isolated` hears nobody: keeps its own row
    return a.astype(np.float32)


LEAVES = [((6, 10), 5), ((6, 11), 5), ((5, 3, 4), 5), ((7, 2, 3), 4), ((6,), 3), ((4, 9, 2, 2), 2)]


@pytest.mark.parametrize("q8", [0, 8])
@pytest.mark.parametrize("shape,k", LEAVES, ids=[f"{s}-k{k}" for s, k in LEAVES])
def test_leaf_average_matches_jax(shape, k, q8):
    m = shape[0]
    rng = np.random.default_rng(len(shape) * 10 + k)
    leaf = rng.standard_normal(shape).astype(np.float32)
    a = _sel(m, k)
    off = rng.integers(0, k, m).astype(np.int32)
    want = np.asarray(jg._leaf_average(jnp.asarray(leaf), jnp.asarray(off), jnp.asarray(a), k,
                                       quantize_bits=q8))
    got = tg._leaf_average(torch.as_tensor(leaf), torch.as_tensor(off), torch.as_tensor(a), k,
                           quantize_bits=q8)
    assert tuple(got.shape) == shape and got.is_contiguous()
    np.testing.assert_allclose(to_np(got), want, rtol=1e-6, atol=1e-6)
    if leaf.ndim > 1:  # receiver 1 heard nobody
        np.testing.assert_array_equal(to_np(got[1]), leaf[1])


def _bf16_ulps_floored(got, want):
    w = want.float()
    mag = torch.maximum(w.abs(), w.abs().max() / 256).clamp(min=2.0 ** -126)
    return ((got.float() - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


@pytest.mark.parametrize("q8", [0, 8])
def test_leaf_average_bf16_matches_jax(q8):
    """bf16 leaves: both sum in f32 (JAX's preferred_element_type), divide
    in f32 and round once; the f32 sums may be taken in another order."""
    m, k = 8, 5
    rng = np.random.default_rng(3)
    leaf = jnp.asarray(rng.standard_normal((m, 23, 16)), jnp.bfloat16)
    a = _sel(m, 4)
    off = rng.integers(0, k, m).astype(np.int32)
    want = jg._leaf_average(leaf, jnp.asarray(off), jnp.asarray(a), k, quantize_bits=q8)
    got = tg._leaf_average(to_t(leaf), torch.as_tensor(off), torch.as_tensor(a), k,
                           quantize_bits=q8)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps_floored(got, to_t(want)) <= 1.0


def test_pytree_matches_jax_with_offsets():
    m, p = 6, 0.25
    rng = np.random.default_rng(5)
    params = {"emb": rng.standard_normal((m, 13, 4)).astype(np.float32),
              "blocks": [rng.standard_normal((m, 2, 8)).astype(np.float32),
                         rng.standard_normal((m,)).astype(np.float32)]}
    a = _sel(m, 6)
    key = jax.random.PRNGKey(7)
    want = jg.compressed_pme_average_pytree(key, jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(a), p)
    k = max(2, round(1 / p))
    offsets = [to_t(jg.systematic_offsets(jax.random.fold_in(key, idx), m, k))
               for idx in range(3)]
    got = tg.compressed_pme_average_pytree(None, convert.to_torch(params), torch.as_tensor(a), p,
                                           offsets=offsets)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6, atol=1e-6)
    # its own draws: offsets in [0, k), and the output never aliases the input
    tparams = convert.to_torch(params)
    own = tg.compressed_pme_average_pytree(3, tparams, torch.as_tensor(a), p)
    for o, x in zip(tree_leaves(own), tree_leaves(tparams)):
        assert o.shape == x.shape and o.data_ptr() != x.data_ptr()
    off = tg.systematic_offsets(torch.Generator().manual_seed(0), 1000, k)
    assert int(off.min()) == 0 and int(off.max()) == k - 1


def test_unbiased_selection_rate():
    """Every coordinate is selected with probability 1/k over the offsets:
    with every receiver hearing every sender, the mean of the averages over
    all k offsets of one sender equals that sender's mean contribution."""
    m, k = 2, 4
    x = torch.arange(2 * 8, dtype=torch.float32).reshape(m, 8)
    a = torch.tensor([[0.0, 1.0], [1.0, 0.0]])
    hits = torch.zeros(8)
    for o in range(k):
        out = tg._leaf_average(x, torch.tensor([o, o]), a, k)
        hits += (out[1] == x[0]).float()
    torch.testing.assert_close(hits, torch.ones(8))


# ---------------------------------------------------------------------------
# PaME with the compressed exchanges against JAX
# ---------------------------------------------------------------------------
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


def _t_cfg(cfg):
    return tpame.PaMEConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _run(cfg, stacked_j, stacked_t, jgrad, tgrad, batch_j, batch_t, topo_args, atol, steps=4,
         max_off=0):
    """`steps` PaME steps of JAX and the port with JAX's draws injected.  Up
    to `max_off` coordinates a step may exceed `atol`, each by at most one
    int8 step of its leaf (max |leaf| / 127): see the LM test."""
    topo = jbuild(*topo_args[:2], **topo_args[2])
    ta_j = jpame.make_topology_arrays(topo, cfg, seed=0)
    ta_t = tpame.make_topology_arrays(tbuild(*topo_args[:2], **topo_args[2]), _t_cfg(cfg),
                                      seed=0, device="cpu")
    key = jax.random.PRNGKey(0)
    sj = jpame.pame_init(key, stacked_j, topo.m, cfg)
    st = tpame.pame_init(0, stacked_t, topo.m, _t_cfg(cfg))
    step_j = jax.jit(lambda s, b: jpame.pame_step(s, b, jgrad, ta_j, cfg))
    for k in range(steps):
        draws = jax_step_draws(key, k, sj.params, ta_j, cfg)
        assert set(draws) == {"a", "offsets"}
        sj, mj = step_j(sj, batch_j)
        st, mt = tpame.pame_step(st, batch_t, tgrad, ta_t, _t_cfg(cfg), draws=draws)
        off = 0
        for g, w in zip(tree_leaves(st.params), jax.tree_util.tree_leaves(sj.params)):
            w = np.asarray(w)
            diff = np.abs(to_np(g) - w)
            if max_off:
                off += int((diff > atol).sum())
                assert diff.max() <= np.abs(w).max() / 127 * 1.01 + atol
            else:
                np.testing.assert_allclose(to_np(g), w, atol=atol)
        assert off <= max_off, f"step {k}: {off} coordinates beyond {atol}"
        for key_ in ("loss_mean", "consensus", "comm_nodes"):
            np.testing.assert_allclose(float(mt[key_]), float(mj[key_]), rtol=1e-5, atol=1e-7,
                                       err_msg=key_)


@pytest.mark.parametrize("mixing", ["dense", "sparse"])
@pytest.mark.parametrize("exchange", ["compressed", "compressed_q8"])
def test_pame_compressed_steps_match_jax(exchange, mixing):
    cfg = jpame.PaMEConfig(nu=0.3, p=0.2, gamma=1.01, sigma0=8.0, exchange=exchange,
                           mixing=mixing)
    w0 = np.random.default_rng(7).standard_normal((M, N)).astype(np.float32)
    _run(cfg, jnp.asarray(w0), torch.tensor(w0), j_grad, t_grad,
         (jnp.asarray(A_NP), jnp.asarray(B_NP)), (torch.as_tensor(A_NP), torch.as_tensor(B_NP)),
         ("erdos_renyi", M, {"p": 0.4, "seed": 1}), atol=1e-5)


@pytest.mark.parametrize("exchange", ["compressed", "compressed_q8"])
def test_pame_compressed_lm_steps_match_jax(exchange):
    """3 steps on the 1-layer LM, to 1e-4.  With int8 payloads, round(x /
    scale · 127) sends a coordinate within ~1e-7 of a rounding boundary to
    the neighbouring level when the two frameworks' f32 gradients differ in
    the last bits: one coordinate, off by 6.9e-4 (one int8 step), on this
    input; at most 8 a step are allowed, each within one int8 step."""
    cfg_j = jget_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    cfg_t = get_config("stablelm-1.6b", "smoke").replace(n_layers=1)
    m = 4
    stacked = jax.vmap(lambda k: jinit(k, cfg_j))(jax.random.split(jax.random.PRNGKey(0), m))
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (m, 1, 16)).astype(np.int32)

    def jgr(p, b, k):
        return jax.value_and_grad(lambda pp: jloss(pp, cfg_j, b))(p)

    def tgr(p, b, k):
        leaves, treedef = tree_flatten(p)
        loss = train_loss(p, cfg_t, b)
        return loss.detach(), tree_unflatten(treedef, list(torch.autograd.grad(loss, leaves)))

    cfg = jpame.PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=20.0, exchange=exchange,
                           homogeneous_kappa=1)
    _run(cfg, stacked, convert.to_torch(jax.device_get(stacked)), jgr, tgr,
         {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)},
         ("erdos_renyi", m, {"p": 0.5, "seed": 0}), atol=1e-4, steps=3,
         max_off=8 if exchange == "compressed_q8" else 0)


@pytest.mark.parametrize("exchange", ["dense", "compressed", "compressed_q8"])
def test_compressed_wire_bits_match_jax(exchange):
    """Eq. (8) at value_bits 64, or 8 for the int8 payloads."""
    hj = JALG.PaMEHp(exchange=exchange)
    ht = TALG.PaMEHp(exchange=exchange)
    tree = {"a": np.zeros((24, 2048), np.float32), "b": [np.zeros(7, np.float32)]}
    bj = JALG.get_algorithm("pame").bind(j_grad, jbuild("erdos_renyi", 4, p=0.5, seed=0), hj)
    bt = TALG.get_algorithm("pame").bind(t_grad, tbuild("erdos_renyi", 4, p=0.5, seed=0), ht,
                                         device="cpu")
    assert bt.wire_bits_for(convert.to_torch(tree)) == bj.wire_bits_for(tree)
    assert bt.wire_bits(1_438_746_624) == bj.wire_bits(1_438_746_624)
