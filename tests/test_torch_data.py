"""The port's data modules against the JAX package's, bit for bit: the
synthetic Example-2 regression and classification images, the three
partitioners over several (m, C, beta, seed), `NodeBatcher` over three
epochs, and every error case of tests/test_partition.py.  All of them are
numpy only, so equality is exact (tolerance 0)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import data as jdata
from repro_torch import data as tdata


def _same(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_exports_match_jax():
    public = {n for n in dir(jdata) if not n.startswith("_")} - {"partition", "pipeline",
                                                                 "synthetic"}
    assert set(tdata.__all__) == public


@pytest.mark.parametrize("m,spn,n,seed,frac", [(4, 16, 50, 1, 0.5), (32, 160, 1000, 0, 0.5),
                                               (3, 7, 11, 5, 0.2)])
def test_logistic_regression_bitwise(m, spn, n, seed, frac):
    _same(tdata.make_logistic_regression(m, spn, n, seed=seed, nonzero_frac=frac),
          jdata.make_logistic_regression(m, spn, n, seed=seed, nonzero_frac=frac))


@pytest.mark.parametrize("n,shape,classes,seed,sep", [
    (600, (28, 28, 1), 10, 0, 3.0), (257, (32, 32, 3), 10, 1, 2.0), (40, (5, 3, 2), 4, 9, 1.0)])
def test_synthetic_classification_bitwise(n, shape, classes, seed, sep):
    got = tdata.SyntheticClassification.make(n, shape, classes, seed=seed, sep=sep)
    want = jdata.SyntheticClassification.make(n, shape, classes, seed=seed, sep=sep)
    assert got.n_classes == want.n_classes
    _same([got.images, got.labels], [want.images, want.labels])
    assert got.images.dtype == np.float32 and got.labels.dtype == np.int32


LABELS = jdata.SyntheticClassification.make(900, (2, 2, 1), 10, seed=3).labels


@pytest.mark.parametrize("m,seed", [(4, 0), (7, 3), (16, 1)])
def test_iid_partition_bitwise(m, seed):
    _same(tdata.iid_partition(LABELS, m, seed=seed), jdata.iid_partition(LABELS, m, seed=seed))


@pytest.mark.parametrize("m,c,seed", [(4, 7, 0), (4, 1, 2), (8, 3, 1), (10, 10, 5), (12, 2, 0)])
def test_label_skew_partition_bitwise(m, c, seed):
    _same(tdata.label_skew_partition(LABELS, m, c, seed=seed),
          jdata.label_skew_partition(LABELS, m, c, seed=seed))


@pytest.mark.parametrize("m,beta,seed", [(4, 0.3, 0), (4, 0.6, 1), (8, 0.3, 2), (16, 5.0, 0)])
def test_dirichlet_partition_bitwise(m, beta, seed):
    _same(tdata.dirichlet_partition(LABELS, m, beta, seed=seed),
          jdata.dirichlet_partition(LABELS, m, beta, seed=seed))


def test_dirichlet_partition_raises_like_jax():
    labels = np.arange(3)  # three samples cannot give 4 nodes two each
    for mod in (jdata, tdata):
        with pytest.raises(RuntimeError, match="min_size"):
            mod.dirichlet_partition(labels, 4, 0.3, seed=0)


# every error case of tests/test_partition.py, against both packages
ERRORS = {
    "above_n_classes": (np.repeat(np.arange(5), 10), 3, 6, "classes_per_node"),
    "nonpositive": (np.repeat(np.arange(5), 10), 3, 0, "classes_per_node"),
    "empty_shard": (np.arange(10), 12, 1, "empty shard"),
    "missing_class": (np.array([0, 0, 2, 2]), 2, 1, "no samples"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_label_skew_errors_match_jax(case):
    labels, m, c, match = ERRORS[case]
    msgs = []
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match=match) as err:
            mod.label_skew_partition(labels, m, classes_per_node=c, seed=0)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("batch,seed", [(32, 0), (5, 3)])
def test_node_batcher_bitwise_over_three_epochs(batch, seed):
    ds = jdata.SyntheticClassification.make(300, (4, 4, 1), 10, seed=0)
    parts = jdata.label_skew_partition(ds.labels, 4, 3, seed=0)
    arrays = {"x": ds.images, "y": ds.labels}
    jb = jdata.NodeBatcher(arrays, parts, batch_size=batch, seed=seed)
    tb = tdata.NodeBatcher(arrays, parts, batch_size=batch, seed=seed)
    # three epochs of the largest shard, so every node reshuffles at least twice
    rounds = 3 * -(-max(len(p) for p in parts) // batch)
    for k in range(rounds):
        got, want = tb.next(k), jb.next(k)
        assert sorted(got) == sorted(want)
        for key in want:
            _same(got[key], want[key])


def test_node_batcher_rejects_empty_shard():
    arrays = {"y": np.arange(4)}
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="empty shard"):
            mod.NodeBatcher(arrays, [np.arange(4), np.array([], np.int64)], 2).next()
