"""The port's topology and synthetic data are bitwise equal to JAX's."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import topology as jtopo
from repro.data import synthetic as jsyn
from repro_torch.core import topology as ttopo
from repro_torch.data import synthetic as tsyn

CASES = [
    ("ring", 7, {}), ("grid", 12, {}), ("complete", 5, {}), ("star", 9, {}),
    ("erdos_renyi", 16, {"p": 0.4, "seed": 1}), ("erdos_renyi", 4, {"p": 0.5, "seed": 0}),
    ("regular", 10, {"degree": 4, "seed": 3}),
]


@pytest.mark.parametrize("kind,m,kw", CASES)
def test_topology_bitwise(kind, m, kw):
    a, b = jtopo.build_topology(kind, m, **kw), ttopo.build_topology(kind, m, **kw)
    np.testing.assert_array_equal(a.adjacency, b.adjacency)
    np.testing.assert_array_equal(a.mixing, b.mixing)
    assert a.zeta == b.zeta and a.neighbor_sets == b.neighbor_sets
    for x, y in zip(a.neighbor_matrix_padded(), b.neighbor_matrix_padded()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.mixing_padded(), b.mixing_padded()):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_unknown_topology_raises():
    with pytest.raises(ValueError, match="unknown topology"):
        ttopo.build_topology("hypercube", 8)


@pytest.mark.parametrize("seed", [0, 5])
def test_linear_regression_bitwise(seed):
    for x, y in zip(jsyn.make_linear_regression(16, 64, 200, seed=seed),
                    tsyn.make_linear_regression(16, 64, 200, seed=seed)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("vocab", [300, 100352])
def test_synthetic_tokens_bitwise(vocab):
    a = jsyn.SyntheticTokens.make(4, 2048, vocab, seed=2).tokens
    b = tsyn.SyntheticTokens.make(4, 2048, vocab, seed=2).tokens
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
