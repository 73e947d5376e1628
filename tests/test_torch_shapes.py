"""The port's input shapes and long-context path against the JAX package's,
on the CPU.

`repro_torch.configs.shapes` against `repro.configs.shapes` for all ten
archs x four shapes (the shapes, the long_500k window policy, cache
capacities, and `input_specs` leaf by leaf in JAX's leaf order, decode
caches included); a windowed prefill and decode past the ring's wrap
against JAX's (weights carried with `repro_torch.convert`, atol 3e-4 as
tests/test_decode_consistency.py); the SSD's blocked inter-chunk scan
against the chunk-by-chunk loop it replaced (atol 1e-5); the flash
wrapper at qwen3-14b's long_500k attention, past 2^31 elements, with a
stand-in launcher; and the chip smoke's path J at tiny sizes.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_arch_names as jall_arch_names
from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models import model as jm
from repro_torch import convert
from repro_torch.configs import get_config, shapes
from repro_torch.kernels.flash_attention import kernel as fkernel
from repro_torch.models import model as tm
from repro_torch.models import ssm

from _torch_parity import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = jall_arch_names()
SHAPES = list(jshapes.INPUT_SHAPES)
ATOL = 3e-4


def test_input_shapes_match_jax():
    assert shapes.LONG_CTX_WINDOW == jshapes.LONG_CTX_WINDOW == 4096
    assert list(shapes.INPUT_SHAPES) == SHAPES
    for name, want in jshapes.INPUT_SHAPES.items():
        assert dataclasses.asdict(shapes.INPUT_SHAPES[name]) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_for_shape_and_capacity_match_jax(arch):
    """The long_500k policy (a 4096-token window on every non-SSM arch
    without one) and each shape's cache capacity, field for field."""
    for name in SHAPES:
        got = shapes.config_for_shape(get_config(arch), shapes.INPUT_SHAPES[name])
        want = jshapes.config_for_shape(jget_config(arch), jshapes.INPUT_SHAPES[name])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert shapes.cache_capacity(got, shapes.INPUT_SHAPES[name]) == \
            jshapes.cache_capacity(want, jshapes.INPUT_SHAPES[name])
    long_cfg = shapes.config_for_shape(get_config(arch), shapes.INPUT_SHAPES["long_500k"])
    assert long_cfg.window == (None if long_cfg.arch_type == "ssm" else 4096)


def _leaves(tree):
    """(shape, dtype name) of each leaf in JAX's order (the port's tree
    module flattens as jax.tree_util does)."""
    if isinstance(tree, torch.Tensor) or hasattr(tree, "dtype"):
        return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_input_specs_match_jax(arch, shape):
    """Every stand-in at full size, shape and type, leaf by leaf in JAX's
    leaf order (the decode caches too), allocating nothing."""
    m = 4
    got = shapes.input_specs(get_config(arch), shapes.INPUT_SHAPES[shape], m_nodes=m)
    want = jshapes.input_specs(jget_config(arch), jshapes.INPUT_SHAPES[shape], m_nodes=m)
    assert sorted(got) == sorted(want)
    for key in want:
        assert _leaves(got[key]) == _leaves(jax.tree_util.tree_leaves(want[key])), key
    assert all(x.device.type == "meta" for x in jax.tree_util.tree_leaves(
        convert.flatten(got)))


@pytest.mark.parametrize("seq", [40, 48])
def test_windowed_prefill_and_decode_past_the_wrap_match_jax(seq):
    """stablelm-smoke at 2 layers with a 16-token window and a ring cache of
    16: a prefill of `seq` tokens (past two wraps) and 12 teacher-forced
    decode steps, logits and caches against JAX's at atol 3e-4.  When seq
    is a multiple of the capacity (as at long_500k: 524,288 = 128 x 4096)
    the ring ends holding the last 16 positions.  At 40 it does not, in JAX
    and in the port alike: the prefill leaves positions 24-39 in slots 0-15
    while decode writes position t to slot t % 16, so decode overwrites
    positions still inside the window (ROADMAP, queue 3)."""
    cj = jget_config("stablelm-1.6b", "smoke").replace(n_layers=2, window=16)
    ct = get_config("stablelm-1.6b", "smoke").replace(n_layers=2, window=16)
    pj = jm.init_params(jax.random.PRNGKey(3), cj)
    pt = convert.to_torch(jax.device_get(pj))
    extra, cap = 12, 16
    tok = np.random.default_rng(4).integers(0, cj.vocab, (2, seq + extra)).astype(np.int32)
    lg_j, c_j = jm.prefill(pj, cj, {"tokens": jnp.asarray(tok[:, :seq])}, cap)
    with torch.no_grad():
        lg_t, c_t = tm.prefill(pt, ct, {"tokens": torch.as_tensor(tok[:, :seq])}, cap)
    np.testing.assert_allclose(to_np(lg_t), np.asarray(lg_j), atol=ATOL)
    for t in range(seq, seq + extra):
        lg_j, c_j = jm.decode_step(pj, cj, jnp.asarray(tok[:, t]), jnp.int32(t), c_j)
        with torch.no_grad():
            lg_t, c_t = tm.decode_step(pt, ct, torch.as_tensor(tok[:, t]), t, c_t)
        np.testing.assert_allclose(to_np(lg_t), np.asarray(lg_j), atol=ATOL, err_msg=str(t))
    for g, w in zip(convert.flatten(c_t), jax.tree_util.tree_leaves(c_j)):
        np.testing.assert_allclose(to_np(g), np.asarray(w, np.float32), atol=ATOL)
    ring = sorted(c_t[0]["0_attn"].positions[0].tolist())
    held = list(range(seq + extra - cap, seq + extra))
    assert (ring == held) == (seq % cap == 0)


def _chunk_loop(cc, cum, states, h0, rep):
    """The inter-chunk recurrence as the port ran it before the blocked
    scan: one step a chunk, every incoming state stacked, C repeated per
    head."""
    decay = torch.exp(cum[:, :, -1, :])
    run = torch.zeros_like(states[:, 0]) if h0 is None else h0
    prev = []
    for k in range(states.shape[1]):
        prev.append(run)
        run = run * decay[:, k, :, None, None] + states[:, k]
    inner = torch.einsum("bnlhs,bnhps->bnlhp", cc.repeat_interleave(rep, dim=3).float(),
                         torch.stack(prev, dim=1))
    return inner * torch.exp(cum)[..., None], run


@pytest.mark.parametrize("nc", [1, 2, 5, 16, 17, 30])
@pytest.mark.parametrize("with_h0", [False, True])
def test_blocked_inter_chunk_scan_equals_the_chunk_loop(nc, with_h0):
    """Nc chunks in blocks of ceil(sqrt(Nc)), the last one padded, G = 2
    groups of 3 heads: the output term and the final state within 1e-5 of
    the chunk-by-chunk loop."""
    g = torch.Generator().manual_seed(nc)
    b, l, grp, rep, p, n = 2, 4, 2, 3, 5, 6
    h = grp * rep
    cc = torch.randn(b, nc, l, grp, n, generator=g)
    cum = torch.cumsum(-torch.rand(b, nc, l, h, generator=g) * 0.3, dim=2)
    states = torch.randn(b, nc, h, p, n, generator=g)
    h0 = torch.randn(b, h, p, n, generator=g) if with_h0 else None
    y, final = ssm._inter_chunk(cc, cum, states, h0, torch.float32)
    y_want, final_want = _chunk_loop(cc, cum, states, h0, rep)
    np.testing.assert_allclose(y.numpy(), y_want.numpy(), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), final_want.numpy(), atol=1e-5)


class _OnCard(torch.Tensor):
    """A meta tensor that reports itself on the card: the wrapper's checks
    and launch run on qwen3-14b's long_500k shape, nothing allocated."""

    @property
    def is_cuda(self):
        return True


def test_flash_wrapper_takes_qwen3_long_500k_attention(monkeypatch):
    """q [1, 524288, 40, 128] holds 2.68e9 elements a batch row, past 2^31:
    the tensor-core wrapper passes it to the launcher (the kernel offsets
    in 64 bits) where it used to refuse it."""
    s, h, kv, d, win = 524_288, 40, 8, 128, 4096
    assert s * h * d >= 2 ** 31
    q = torch.empty((1, s, h, d), dtype=torch.bfloat16, device="meta").as_subclass(_OnCard)
    k = torch.empty((1, s, kv, d), dtype=torch.bfloat16, device="meta").as_subclass(_OnCard)
    calls = []

    def launcher(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(fkernel, "_bind", lambda: launcher)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(fkernel.flash_attention_cuda, "launches", 0)
    monkeypatch.setattr(fkernel.flash_attention_cuda, "variant_launches",
                        dict.fromkeys(fkernel.VARIANTS, 0))
    out = fkernel.flash_attention_cuda(q, k, k, window=win)
    assert tuple(out.shape) == (1, s, h, d)
    (args,) = calls
    # B, S, H, KV, D, window, scale, dtype code, variant code
    assert args[4:9] == (1, s, h, kv, d) and args[9] == win
    assert args[11:13] == (1, fkernel.VARIANTS["tensor_cores"])
    assert fkernel.flash_attention_cuda.variant_launches["tensor_cores"] == 1


@pytest.mark.parametrize("kv,lo,block", [(4, 0, 7), (2, 20, 16), (1, 63, 64)])
def test_chip_smoke_causal_plain_rows_equals_attention_ref(kv, lo, block):
    """chip_smoke.py's blocked plain attention (row 4j's reference at J2's
    32,768 tokens, where [S, S] scores do not fit) gives `attention_ref`'s
    rows lo..S: blocks that do not divide S, GQA groups, one last row."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(7)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               for shape in ((2, 64, 4, 16), (2, 64, kv, 16), (2, 64, kv, 16)))
    torch.testing.assert_close(cs.causal_plain_rows(q, k, v, lo, block),
                               attention_ref(q, k, v)[:, lo:], rtol=1e-5, atol=1e-6)


def test_chip_smoke_path_j_rehearsal():
    """Path J of chip_smoke.py at tiny sizes on the CPU: J1 through the
    trainer CLI in a fresh process with --compile-cache (smoke config, 16
    tokens), J2 + J3 and J4 on smoke configs with short prompts (the
    kernels' plain versions: no launch counted), a ring that wraps, and J5's
    dry runs of two smoke combos."""
    import tempfile

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    dev = torch.device("cpu")
    j1 = cs.path_j1(dev, batch=1, seq=16, variant="smoke")
    assert j1["steps"] == 3 and j1["cache_logged"] and len(j1["loss"]) == 3
    cfg = get_config("stablelm-1.6b", "smoke").replace(window=16, use_flash=True)
    row = cs.serve_shape(dev, cfg, 2, 64, 16, 5, "tiny")
    assert row["ring_ok"] and row["ring"]["max"] == 68 and row["token_shape"] == [2, 6]
    j2 = cs.path_j2(dev, batch=2, gen=3, seq=64, variant="smoke")
    assert j2["ring_ok"] and j2["reduced"]["global_batch"]["decode_32k"] == [128, 2]
    j4 = cs.path_j4(dev, seq=256, gen=4, variant="smoke")
    assert sorted(j4) == ["J4a", "J4b", "J4c"]
    assert j4["J4a"]["window"] == 4096 and j4["J4b"]["window"] is None
    combos = (("a", ["--arch", "stablelm-1.6b", "--shape", "train_4k", "--batch", "8",
                     "--size", "smoke"]),
              ("b", ["--arch", "mamba2-1.3b", "--shape", "long_500k", "--kind", "prefill",
                     "--size", "smoke"]))
    recs = cs.run_dryruns(80e9, tempfile.mkdtemp(), combos)
    assert recs["a"]["kind"] == "train" and recs["a"]["reduced"] == {"global_batch": [256, 8]}
    assert recs["b"]["kind"] == "prefill" and recs["b"]["flops"] > 0
