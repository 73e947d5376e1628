"""The port's one-card dry run (`repro_torch.launch.dryrun`) and its
compilation cache (`engine.setup_compilation_cache`), on the CPU.

Parameter, state, input and cache bytes of every (arch x shape) step
against the trees JAX's dry run builds with `jax.eval_shape` (exact); the
counted FLOPs of stablelm-smoke's train step, prefill and decode step
within 1% of an analytic count; a record through the JSON file and back;
and where the kernels' libraries go.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_arch_names as jall_arch_names
from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.models import model as jm
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import engine
from repro_torch.kernels import _build
from repro_torch.launch import dryrun

ARCHS = jall_arch_names()
M = 4


def _bytes(tree):
    return int(sum(np.prod(x.shape) * np.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_bytes_match_jax_eval_shape(arch, shape):
    """Each step's bytes at the shape's real batch, from the port's meta
    stand-ins and from JAX's eval_shape trees: parameters, the 4-node
    state's parameters and sigma, inputs, and the cache (prefill: the one
    it returns at cache_capacity; decode: input_specs')."""
    jcfg = jshapes.config_for_shape(jget_config(arch), jshapes.INPUT_SHAPES[shape])
    jshape = jshapes.INPUT_SHAPES[shape]
    kind = jshape.kind
    cfg = dryrun._resolve(arch, shape, remat=False)[1]
    got = dryrun.step_bytes(dryrun.step_specs(cfg, INPUT_SHAPES[shape], kind,
                                              jshape.global_batch, M))
    params = _bytes(jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg)))
    assert got["param_bytes"] == params
    specs = jshapes.input_specs(jcfg, jshape, m_nodes=M)
    if kind == "train":
        assert got["state_bytes"] == M * params + 4 * M  # + sigma [m] f32
        assert got["input_bytes"] == _bytes(specs)
        assert got["cache_bytes"] == 0
    elif kind == "prefill":
        assert got["input_bytes"] == _bytes(specs)
        cap = jshapes.cache_capacity(jcfg, jshape)
        assert got["cache_bytes"] == _bytes(jax.eval_shape(
            lambda: jm.init_cache(jcfg, jshape.global_batch, cap)))
    else:
        assert got["input_bytes"] == _bytes(specs["token"])
        assert got["cache_bytes"] == _bytes(specs["cache"])


def _analytic(cfg, kind, batch, seq, m=M, remat=True, capacity=None):
    """Matrix-product operations of stablelm-smoke's steps: each layer's
    projections and MLP, attention over whole [S, S] blocks (the plain
    version's), the tied head; a train step's backward doubles each product
    and remat recomputes the layers once; PaME's Bernoulli exchange is two
    [m, m] x [m, n] products a leaf.  The recompute stops early, as the
    non-reentrant checkpoint does once every saved tensor is rebuilt: each
    layer's last product (the MLP's down projection) is not rerun."""
    d, h, kv, hd, ff, vocab, layers = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                       cfg.d_ff, cfg.vocab, cfg.n_layers)
    per_token = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
    if kind == "decode":
        return batch * (layers * (per_token + 4 * h * hd * capacity) + 2 * d * vocab)
    trunk = layers * (batch * seq * per_token + 4 * batch * h * hd * seq * seq)
    if kind == "prefill":
        return trunk + 2 * batch * d * vocab  # the head at the last position only
    head = 2 * batch * seq * d * vocab
    recompute = trunk - layers * batch * seq * 2 * d * ff
    node = 3 * (trunk + head) + (recompute if remat else 0)
    return m * node + 2 * 2 * m * m * cfg.param_count()


@pytest.mark.parametrize("kind,shape,batch", [("train", "train_4k", 8),
                                              ("prefill", "prefill_32k", 2),
                                              ("decode", "decode_32k", 4)])
def test_flops_match_analytic_count(kind, shape, batch):
    cfg = get_config("stablelm-1.6b", "smoke")
    rec = dryrun.run_combo("stablelm-1.6b", shape, device_bytes=80e9, size="smoke",
                           batch=batch, nodes=M)
    seq = INPUT_SHAPES[shape].seq_len
    want = _analytic(cfg, kind, batch if kind != "train" else batch // M, seq,
                     capacity=rec.get("capacity"))
    assert abs(rec["flops"] - want) <= 0.01 * want, (rec["flops"], want)
    assert rec["reduced"] == {"global_batch": [INPUT_SHAPES[shape].global_batch, batch]}
    if kind == "prefill":
        att = rec["attention_flops"]
        assert att["band"] == att["full"] * (seq + 1) // (2 * seq)  # the causal half
        assert rec["flops_band"] == rec["flops"] - att["full"] + att["band"]


def test_record_roundtrips_through_the_json_file(tmp_path, capsys):
    """A smoke record written by the CLI reads back equal, and a second run
    skips it as cached."""
    out = tmp_path / "dry.json"
    argv = ["--arch", "stablelm-1.6b", "--size", "smoke", "--shape", "prefill_32k",
            "--batch", "2", "--device-bytes", "8e10", "--devices", "8", "--out", str(out)]
    results = dryrun.main(argv)
    (key,) = results
    rec = results[key]
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert rec["fits_one_card"] and rec["layout"] == {"node": 8, "fsdp": 1, "model": 1,
                                                      "devices": 8}
    assert rec["per_device_bytes"]["total"] == sum(
        v for k, v in rec["per_device_bytes"].items() if k != "total")
    capsys.readouterr()
    assert dryrun.main(argv) == json.loads(out.read_text())
    assert f"skip cached {key}" in capsys.readouterr().out


def test_dryrun_needs_the_cards_memory(monkeypatch, tmp_path):
    """Without a card and without --device-bytes the dry run raises: it
    never guesses a budget."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device-bytes"):
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                     "--out", str(tmp_path / "x.json")])


@pytest.mark.parametrize("case", ["unset", "environment", "explicit"])
def test_compilation_cache_points_the_kernel_builds(case, tmp_path, monkeypatch):
    """None (nothing moved) when neither a directory nor
    REPRO_COMPILE_CACHE is given; the environment's otherwise, and an
    explicit directory over it: the kernels' libraries are then built into
    and loaded from that directory."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    default = _build._target("flash_attention")
    monkeypatch.delenv("REPRO_COMPILE_CACHE", raising=False)
    if case != "unset":
        monkeypatch.setenv("REPRO_COMPILE_CACHE", str(tmp_path / "env"))
    explicit = str(tmp_path / "explicit") if case == "explicit" else None
    got = engine.setup_compilation_cache(explicit)
    want = {"unset": None, "environment": str(tmp_path / "env"),
            "explicit": str(tmp_path / "explicit")}[case]
    assert got == want
    target = _build._target("flash_attention")
    if want is None:
        assert target == default
    else:
        assert target.parent == (tmp_path / case.replace("environment", "env")).resolve()
        assert target.name == default.name  # the same source hash, another directory
