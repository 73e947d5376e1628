"""The port's PME averages against JAX's with injected draws (f32 atol
1e-5), and the port's own samplers held to their invariants."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build_topology as jbuild
from repro.core import pme as jpme
from repro_torch.core import build_topology as tbuild
from repro_torch.core import pme as tpme

from _torch_parity import to_np, to_t

ATOL = 1e-5


def _tree(m, seed):
    rng = np.random.default_rng(seed)
    return {
        "b": jnp.asarray(rng.standard_normal((m, 6)), jnp.float32),
        "a": jnp.asarray(rng.standard_normal((m, 4, 8)), jnp.float32),
        "c": [jnp.asarray(rng.standard_normal((m,)), jnp.float32)],
    }


def _masks(key, tree, p, mode):
    leaves = jax.tree_util.tree_leaves(tree)
    m = leaves[0].shape[0]
    out = []
    for idx, leaf in enumerate(leaves):
        lkey = jax.random.fold_in(key, idx)
        if mode == "exact":
            n = int(np.prod(leaf.shape[1:]))
            out.append(jpme.sample_coordinate_masks(lkey, m, n, max(1, round(p * n))))
        else:
            out.append(jax.random.bernoulli(lkey, p, leaf.shape))
    return out


def _assert_tree_close(got, want, atol=ATOL):
    for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(to_np, got,
                    is_leaf=lambda x: isinstance(x, torch.Tensor))),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol)


@pytest.mark.parametrize("mode", ["exact", "bernoulli"])
def test_pme_average_pytree_matches_jax(mode):
    m = 8
    tree = _tree(m, 0)
    rng = np.random.default_rng(1)
    a = jnp.asarray((rng.random((m, m)) < 0.5).astype(np.float32))
    key = jax.random.PRNGKey(3)
    want = jpme.pme_average_pytree(key, tree, a, 0.4, mode=mode)
    masks = [to_t(x) for x in _masks(key, tree, 0.4, mode)]
    got = tpme.pme_average_pytree(None, jax.tree_util.tree_map(to_t, tree), to_t(a), 0.4,
                                  mode=mode, masks=masks)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("mode", ["exact", "bernoulli"])
def test_pme_average_pytree_padded_matches_jax(mode):
    m = 10
    topo = jbuild("erdos_renyi", m, p=0.5, seed=4)
    nbrs, valid = (jnp.asarray(v) for v in topo.neighbor_matrix_padded())
    t = jnp.maximum((0.6 * valid.sum(axis=1)).astype(jnp.int32), 1)
    sel = jpme.sample_neighbor_selection_padded(
        jax.random.PRNGKey(0), nbrs, valid, t, jnp.arange(m) % 3 != 0)
    tree = _tree(m, 6)
    key = jax.random.PRNGKey(1)
    want = jpme.pme_average_pytree_padded(key, tree, nbrs, sel, 0.5, mode=mode,
                                          pad=~valid, impl="slots")
    masks = [to_t(x) for x in _masks(key, tree, 0.5, mode)]
    for impl in ("slots", "segsum", "kernel"):
        got = tpme.pme_average_pytree_padded(
            None, jax.tree_util.tree_map(to_t, tree), to_t(nbrs), to_t(sel), 0.5,
            mode=mode, pad=~to_t(valid), impl=impl, masks=masks)
        _assert_tree_close(got, want)


def test_pme_average_own_and_naive_match_jax():
    m, n = 6, 40
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    own = jnp.asarray(rng.standard_normal((m, n)), jnp.float32)
    masks = jnp.asarray(rng.random((m, n)) < 0.3)
    a = jnp.asarray((rng.random((m, m)) < 0.5).astype(np.float32))
    np.testing.assert_allclose(
        to_np(tpme.pme_average(to_t(w), to_t(masks), to_t(a), own=to_t(own))),
        np.asarray(jpme.pme_average(w, masks, a, own=own)), atol=ATOL)
    np.testing.assert_allclose(
        to_np(tpme.naive_average(to_t(w), to_t(masks), to_t(a))),
        np.asarray(jpme.naive_average(w, masks, a)), atol=ATOL)


def test_selection_with_injected_uniforms_matches_jax():
    m = 12
    topo = jbuild("erdos_renyi", m, p=0.4, seed=2)
    nbrs, valid = (np.asarray(v) for v in topo.neighbor_matrix_padded())
    t = np.maximum(1, np.floor(0.5 * topo.degrees)).astype(np.int32)
    comm = np.arange(m) % 2 == 0
    key = jax.random.PRNGKey(5)
    u = jax.random.uniform(key, nbrs.shape)
    args_j = (key, jnp.asarray(nbrs), jnp.asarray(valid), jnp.asarray(t), jnp.asarray(comm))
    args_t = (None, torch.as_tensor(nbrs), torch.as_tensor(valid), torch.as_tensor(t),
              torch.as_tensor(comm))
    np.testing.assert_array_equal(
        to_np(tpme.sample_neighbor_selection_padded(*args_t, u=to_t(u))),
        np.asarray(jpme.sample_neighbor_selection_padded(*args_j)))
    np.testing.assert_array_equal(
        to_np(tpme.sample_neighbor_selection(*args_t, u=to_t(u))),
        np.asarray(jpme.sample_neighbor_selection(*args_j)))
    # Bernoulli masks from injected uniforms are JAX's bit for bit
    ub = jax.random.uniform(key, (4, 50))
    np.testing.assert_array_equal(
        to_np(tpme.sample_coordinate_masks(None, 4, 50, 10, "bernoulli", u=to_t(ub))),
        np.asarray(jax.random.bernoulli(key, 0.2, (4, 50))))


@pytest.mark.parametrize("seed", range(4))
def test_own_samplers_invariants(seed):
    m = 14
    topo = tbuild("erdos_renyi", m, p=0.3, seed=seed)
    nbrs, valid = (torch.as_tensor(v) for v in topo.neighbor_matrix_padded())
    t = torch.as_tensor(np.maximum(1, np.floor(0.5 * topo.degrees)).astype(np.int32))
    comm = torch.as_tensor(np.random.default_rng(seed).random(m) < 0.6)
    g = tpme.make_generator(seed, "cpu")
    sel = tpme.sample_neighbor_selection_padded(g, nbrs, valid, t, comm)
    assert not (sel & ~valid).any()                       # never a pad slot
    assert (sel.sum(1) <= t).all()                        # at most t_i picks
    assert not sel[~comm].any()                           # silent receivers
    np.testing.assert_array_equal(                        # exactly t_i when enough
        to_np(sel.sum(1)[comm]), np.minimum(to_np(t), to_np(valid.sum(1)))[to_np(comm)])
    a = tpme.sample_neighbor_selection(g, nbrs, valid, t, comm)
    assert a.diagonal().eq(0).all() and a.sum(0).le(t.float()).all()
    for n, s in [(100, 20), (37, 37), (1000, 1)]:
        mk = tpme.sample_coordinate_masks(g, 5, n, s, "exact")
        assert (mk.sum(1) == s).all()                     # |T_j| = s exactly


def test_bernoulli_sampler_rate():
    g = tpme.make_generator(0, "cpu")
    mk = tpme.sample_bernoulli_masks(g, 0.2, (8, 20000))
    assert abs(mk.float().mean().item() - 0.2) < 0.005


def test_fold_in_is_deterministic_and_spreads():
    assert tpme.fold_in(3, 7) == tpme.fold_in(3, 7)
    assert len({tpme.fold_in(3, i) for i in range(100)}) == 100


def test_message_bits_match_jax():
    sizes = (100, 2048, 7)
    rates = (0.2, 0.5, 1.0)
    assert tpme.tree_message_bits(sizes, rates) == jpme.tree_message_bits(sizes, rates)
    assert tpme.message_bits(10, 100, 8) == jpme.message_bits(10, 100, 8)
    assert tpme.leaf_rates(3, 0.3) == jpme.leaf_rates(3, 0.3)
    with pytest.raises(ValueError):
        tpme.leaf_rates(2, 0.3, (0.2,))
