"""The port's vision models (`repro_torch.models.cnn`) against
`repro.models.cnn` on the same seeded numpy inputs, the JAX init carried
across with `repro_torch.convert.to_torch`: the SAME convolution alone
(stride 1 and 2, even and odd sizes: XLA pads a stride-2 3x3 conv (0, 1)),
the SAME max pool on odd sizes, GroupNorm, the CNN's logits at widths 1
and 2, ResNet-20's logits, and the ``ce_loss`` value and gradients of both
models against ``jax.value_and_grad``, all at rtol 1e-5 / atol 1e-5; the
port's own init gives JAX's tree (leaf order and shapes); the convolutions
run under the IEEE-fp32 pin in the forward and the backward pass, and the
pin is scoped."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import cnn as J
from repro_torch import convert
from repro_torch.models import cnn as T
from repro_torch.tree import tree_flatten, tree_unflatten

RTOL = ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw,k,cin,cout,stride", [
    ((32, 32), 3, 3, 16, 2),   # ResNet-20's stage-2/3 first block: pads (0, 1)
    ((32, 32), 3, 16, 16, 1),
    ((16, 16), 1, 16, 32, 2),  # the 1x1 proj at stride 2: no pad
    ((7, 9), 3, 5, 4, 2),      # odd sizes: pads (1, 1) rows, (1, 1) columns
    ((28, 28), 3, 1, 32, 1),
    ((6, 5), 3, 2, 3, 3),
])
def test_same_conv_matches_jax(hw, k, cin, cout, stride):
    rng = _rng(1)
    x = rng.standard_normal((2,) + hw + (cin,)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    _close(T._conv(torch.tensor(x), torch.tensor(w), stride),
           J._conv(jnp.asarray(x), jnp.asarray(w), stride))


def test_symmetric_padding_would_not_match():
    """The reason for the split: F.conv2d(padding=1) at stride 2 on 32x32
    lands far from JAX's SAME."""
    rng = _rng(2)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 16)).astype(np.float32)
    sym = torch.nn.functional.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                                     torch.tensor(w).permute(3, 2, 0, 1), stride=2, padding=1)
    want = np.asarray(J._conv(jnp.asarray(x), jnp.asarray(w), 2))
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0
    assert T._same_pads(32, 3, 2) == (0, 1) and T._same_pads(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("hw", [(28, 28), (7, 7), (7, 9), (5, 4), (1, 3)])
def test_same_pool_matches_jax(hw):
    x = _rng(3).standard_normal((2,) + hw + (3,)).astype(np.float32)
    got = T._pool(torch.tensor(x))
    want = J._pool(jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [16, 64, 4, 24])
def test_group_norm_matches_jax(c):
    rng = _rng(4)
    x = (3.0 * rng.standard_normal((2, 5, 6, c)) + 1.0).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    _close(T._group_norm(torch.tensor(x), torch.tensor(s), torch.tensor(b)),
           J._group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))


def _jax_tree_shapes(tree):
    return [x.shape for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("width", [1, 2])
def test_cnn_init_gives_jax_tree(width):
    got = T.cnn_init(0, width=width)
    want = J.cnn_init(jax.random.PRNGKey(1), width=width)
    leaves, _ = tree_flatten(got)
    assert [tuple(x.shape) for x in leaves] == _jax_tree_shapes(want)
    assert sorted(got) == sorted(want)
    assert sum(x.numel() for x in leaves) == {1: 421_546, 2: 1_682_762}[width]
    # JAX's scales: He normal convs, 1/sqrt(fan_in) dense, zero biases
    assert abs(float(leaves[4].std()) - (7 * 7 * 64 * width) ** -0.5) < 0.05 * (
        7 * 7 * 64 * width) ** -0.5
    assert float(leaves[0].abs().max()) == 0.0 and float(leaves[1].abs().max()) == 0.0


def test_resnet20_init_gives_jax_tree():
    got = T.resnet20_init(0)
    want = J.resnet20_init(jax.random.PRNGKey(1))
    leaves, _ = tree_flatten(got)
    assert [tuple(x.shape) for x in leaves] == _jax_tree_shapes(want)
    assert len(leaves) == 61 and sum(x.numel() for x in leaves) == 272_282
    assert isinstance(got["blocks"], list) and len(got["blocks"]) == 9
    assert [sorted(b) for b in got["blocks"]] == [sorted(b) for b in want["blocks"]]


def _value_and_grad(apply_t, params_t, x, y):
    leaves, treedef = tree_flatten(params_t)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    loss = T.ce_loss(apply_t(tree_unflatten(treedef, leaves), torch.tensor(x)), torch.tensor(y))
    return loss.detach(), torch.autograd.grad(loss, leaves)


MODELS = {
    "cnn-w1": (lambda k: J.cnn_init(k), J.cnn_apply, T.cnn_apply, (28, 28, 1)),
    "cnn-w2": (lambda k: J.cnn_init(k, width=2), J.cnn_apply, T.cnn_apply, (28, 28, 1)),
    "resnet20": (J.resnet20_init, J.resnet20_apply, T.resnet20_apply, (32, 32, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_loss_and_grads_match_jax(name):
    jinit, japply, tapply, shape = MODELS[name]
    pj = jinit(jax.random.PRNGKey(1))
    pt = convert.to_torch(jax.device_get(pj))
    rng = _rng(5)
    x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    _close(tapply(pt, torch.tensor(x)), japply(pj, jnp.asarray(x)))
    lj, gj = jax.value_and_grad(lambda p: J.ce_loss(japply(p, jnp.asarray(x)),
                                                    jnp.asarray(y)))(pj)
    lt, gt = _value_and_grad(tapply, pt, x, y)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)
    for g, w in zip(gt, jax.tree_util.tree_leaves(gj)):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_ce_loss_takes_int32_labels():
    logits = _rng(6).standard_normal((5, 10)).astype(np.float32)
    y = np.array([0, 9, 3, 3, 1], np.int32)
    got = T.ce_loss(torch.tensor(logits), torch.tensor(y))
    _close(got, J.ce_loss(jnp.asarray(logits), jnp.asarray(y)))


def test_convolutions_pin_ieee_fp32_in_forward_and_backward(monkeypatch):
    """cuDNN allows TF32 by default; every convolution of the CNN runs with
    it off, in the forward and in autograd's later backward, and the
    process-wide flag is what it was before and after."""
    seen = []
    real = T._ieee_fp32

    def recording():
        seen.append("enter")
        return real()

    monkeypatch.setattr(T, "_ieee_fp32", recording)
    flags = []
    conv2d = torch.nn.functional.conv2d

    def spy(*a, **kw):
        flags.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    params = T.cnn_init(0)
    x = torch.tensor(_rng(7).standard_normal((2, 28, 28, 1)).astype(np.float32))
    y = torch.tensor(np.array([1, 2], np.int32))
    leaves, treedef = tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    loss = T.ce_loss(T.cnn_apply(tree_unflatten(treedef, leaves), x), y)
    assert flags == [False, False] and len(seen) == 2
    assert torch.backends.cudnn.allow_tf32 is True
    torch.autograd.grad(loss, leaves)
    assert len(seen) == 4  # one pin per convolution's backward
    assert torch.backends.cudnn.allow_tf32 is True
