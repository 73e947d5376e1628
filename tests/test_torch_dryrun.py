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
    # the memory record and the fit on its peak; the sharded prefill over 8
    # one-rank model groups moves no byte
    assert rec["fits_one_card"] == (rec["memory"]["peak_bytes"] <= 8e10)
    assert rec["memory"]["peak_bytes"] >= rec["resident_bytes"] - rec["cache_bytes"]
    assert rec["mem_trace_s"] > 0 and rec["memory"]["code_bytes"] is None
    assert rec["collective_bytes"] == {"all_gather": 0, "all_reduce": 0}
    assert rec["collective_note"] == dryrun.SERVING_NOTE
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


def _small(kind="train", seq=64, batch=8):
    from repro_torch.configs.shapes import InputShape

    return InputShape(f"{kind}_small", seq, batch, kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_memory_record_is_consistent(kind):
    """Each step's memory trace: the peak holds at least the arguments,
    temp = peak - argument bytes, the arguments are the step's inputs
    (state or parameters, batch, a decode's cache) and code bytes have no
    counterpart."""
    cfg = get_config("stablelm-1.6b", "smoke").replace(remat=kind == "train")
    shape = _small(kind, seq=64, batch=8 if kind == "train" else 2)
    specs = dryrun.step_specs(cfg, shape, kind, shape.global_batch, M)
    mem = dryrun.trace_memory(cfg, shape, kind, specs)
    b = dryrun.step_bytes(specs)
    args = {"train": b.get("state_bytes", 0) + b["input_bytes"],
            "prefill": b["param_bytes"] + b["input_bytes"],
            "decode": b["param_bytes"] + b["cache_bytes"] + b["input_bytes"]}[kind]
    assert mem["argument_bytes"] == args
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0 and mem["code_bytes"] is None


def test_kernel_route_drops_the_plain_attentions_scores():
    """A prefill with the `kernels` variant's flags traces flash's route:
    no [S, S] f32 scores, so its peak is below the plain route's by at least
    most of one layer's scores, and above the parameters and the cache."""
    base = get_config("stablelm-1.6b", "smoke")
    shape = _small("prefill", seq=2048, batch=2)
    peaks = {}
    for name, cfg in (("plain", base), ("kernels", base.replace(**dryrun.VARIANTS["kernels"]))):
        specs = dryrun.step_specs(cfg, shape, "prefill", 2, M)
        peaks[name] = dryrun.trace_memory(cfg, shape, "prefill", specs)["peak_bytes"]
        floor = sum(dryrun.step_bytes(specs)[k] for k in ("param_bytes", "cache_bytes"))
        assert peaks[name] > floor
    scores = 2 * base.n_heads * 2048 * 2048 * 4
    assert peaks["plain"] - peaks["kernels"] >= scores // 2


@pytest.mark.parametrize("layout", [{"node": 8, "fsdp": 1, "model": 1},
                                    {"node": 2, "fsdp": 4, "model": 1}])
def test_collective_bytes_follow_the_placements(layout):
    """The sharded step's gather-whole route (a grad_fn that takes no view)
    at 8 fake ranks, with JAX's convention (an all-gather counts its
    result, an all-reduce twice its tensor, a group of one rank nothing):
    each rank all-gathers its piece of every leaf over node (node x its m /
    node rows' piece), each local node's fsdp-placed leaves over fsdp
    before its gradient (fsdp x the row's piece), and the losses and sigma
    over node; it all-reduces the consensus sums (2 x the f32 node sum of
    its piece, then 2 x 4 bytes over each axis of more than one rank).
    Each byte is counted under its use."""
    from repro_torch import sharding as shd
    from repro_torch.launch.train import lm_grad_fn

    cfg = get_config("stablelm-1.6b", "smoke").replace(remat=True)
    shape = _small()
    whole = lm_grad_fn(cfg)
    got = dryrun.sharded_collectives(cfg, shape, layout, shape.global_batch,
                                     grad_fn=lambda p, b, k: whole(p, b, k))
    m, node, fsdp = layout["node"], layout["node"], layout["fsdp"]
    r = m // node
    specs = dryrun.step_specs(cfg, shape, "train", shape.global_batch, m)
    place = shd.state_shardings(specs["state"], layout)
    from repro_torch.tree import tree_leaves

    exchange = gradient = 0
    gather_metrics = 2 * node * r * 4  # the losses and sigma, f32
    reduce = sum(2 * 4 for g in layout.values() if g > 1)  # the consensus scalar
    for leaf, spec in zip(tree_leaves(specs["state"].params),
                          shd.leaf_specs(specs["state"].params, place.params)):
        ways = 1
        for e in spec[1:]:
            for name in shd.spec_axes(e):
                ways *= layout[name]
        row = leaf.numel() // m * leaf.element_size() // ways
        exchange += node * r * row
        if any("fsdp" in shd.spec_axes(e) for e in spec[1:]):
            gradient += r * fsdp * row
        reduce += 2 * (leaf.numel() // m // ways) * 4
    assert got["m"] == m
    assert got["bytes"]["all_gather"] == exchange + gradient + gather_metrics
    assert got["bytes"]["all_reduce"] == reduce
    assert got["by_use"]["all_gather"] == {
        u: b for u, b in (("exchange", exchange), ("gradient", gradient),
                          ("metrics", gather_metrics)) if b or u != "gradient"}
    assert got["by_use"]["all_reduce"] == {"metrics": reduce}
    if fsdp > 1:
        assert gradient > 0


def test_memory_trace_adds_the_cuda_temporaries():
    """The temporaries CUDA code allocates inside a launch (`CUDA_TEMPS`,
    from tools/memory_probe.py on the card) raise a bf16 train step's peak
    by the plain attention's softmax backward buffer, [B, H, 1, S, S] f32,
    which is live at the step's peak; a prefill has none of those ops."""
    base = get_config("stablelm-1.6b", "smoke").replace(dtype="bfloat16")
    peaks = {}
    for kind, seq, batch in (("train", 512, 8), ("prefill", 512, 2)):
        cfg = base.replace(remat=kind == "train")
        shape = _small(kind, seq=seq, batch=batch)
        specs = dryrun.step_specs(cfg, shape, kind, batch, M)
        rules = dict(dryrun.CUDA_TEMPS)
        try:
            with_temps = dryrun.trace_memory(cfg, shape, kind, specs)["peak_bytes"]
            dryrun.CUDA_TEMPS.clear()
            without = dryrun.trace_memory(cfg, shape, kind, specs)["peak_bytes"]
        finally:
            dryrun.CUDA_TEMPS.update(rules)
        peaks[kind] = with_temps - without
    assert peaks["train"] == 8 // M * base.n_heads * 512 * 512 * 4
    assert peaks["prefill"] == 0


def _serving_bytes(cfg, layout, kind, batch, seq):
    """The counted bytes a device of a dense GQA arch's sharded prefill or
    decode (S = 1) over `layout`, by kind and use, in the parameters' type
    (e bytes an element), for B rows a rank and L layers, where the heads,
    KV heads, hidden columns and vocab all divide by t = layout["model"]:
    all-reduce 2 (2L + 1) B S d e (wo, w_down and the embedding); cache
    all-gather 2L B S KV hd e (K and V), logits B V 4; plus the fsdp
    weight gathers, each leaf once a use (the tied embedding twice: the
    lookup and the logits) at its bytes over t where `model` splits it."""
    from repro_torch import sharding as shd
    from repro_torch.tree import tree_leaves

    t, f = layout["model"], layout["fsdp"]
    e = 4 if cfg.dtype == "float32" else 2
    rows = batch // (layout["node"] * f) if batch % (layout["node"] * f) == 0 else batch
    s = seq if kind == "prefill" else 1
    lay = cfg.n_layers
    params = dryrun.abstract_params(cfg)
    specs = shd.params_shardings(params, layout, node_stacked=False)
    weights = 0
    for leaf, spec in zip(tree_leaves(params), shd.leaf_specs(params, specs)):
        names = {n for entry in spec for n in shd.spec_axes(entry)}
        if "fsdp" in names:
            uses = 2 if spec == specs["embed"] and cfg.tie_embeddings else 1
            weights += uses * leaf.numel() * e // (t if "model" in names else 1)
    if t == 1:
        return {"all_gather": {"weights": weights} if weights else {}, "all_reduce": {}}
    return {"all_gather": dict({"cache": 2 * lay * rows * s * cfg.n_kv_heads * cfg.head_dim * e,
                                "logits": rows * cfg.vocab * 4},
                               **({"weights": weights} if weights else {})),
            "all_reduce": {"activations": 2 * 2 * lay * rows * s * cfg.d_model * e,
                           "embed": 2 * rows * s * cfg.d_model * e}}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("model_axis", [4, 1])
def test_serving_record_collectives(kind, model_axis, tmp_path):
    """The CLI's smoke prefill and decode records at --devices 8 and
    --model-axis 4 (2 x 1 x 4) and 1 (8 x 1 x 1): collective bytes by kind
    and by use as `_serving_bytes` counts them, the leaves gathered over
    `model` (none: stablelm-smoke's pieces line up), and one rank's peak
    below the one-card peak where `model` splits the step."""
    shape = {"prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    out = tmp_path / "dry.json"
    (rec,) = dryrun.main(["--arch", "stablelm-1.6b", "--size", "smoke", "--shape", shape,
                          "--batch", "2", "--device-bytes", "8e10", "--devices", "8",
                          "--model-axis", str(model_axis), "--out", str(out)]).values()
    layout = {k: rec["layout"][k] for k in ("node", "fsdp", "model")}
    assert layout["model"] == model_axis and layout["node"] * layout["fsdp"] * model_axis == 8
    cfg = get_config("stablelm-1.6b", "smoke")
    want = _serving_bytes(cfg, layout, kind, 2, INPUT_SHAPES[shape].seq_len)
    assert rec["collective_bytes_by_use"] == want
    assert rec["collective_bytes"] == {k: sum(v.values()) for k, v in want.items()}
    assert rec["collective_bytes_total"] == sum(rec["collective_bytes"].values())
    assert rec["gathered_over_model"] == []
    dev, one = rec["per_device_memory"]["peak_bytes"], rec["memory"]["peak_bytes"]
    if model_axis > 1:
        assert 0 < dev < one
    else:
        assert dev == one


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_collectives_gather_over_fsdp_and_model(kind):
    """The sharded serving step at (1, 2, 4), 4 rows: stablelm-smoke's
    bytes with the per-layer gathers over fsdp (`_serving_bytes`); and
    qwen3-smoke (5 heads on 1 KV head) gathers its wq, wk and wv over
    `model`, whose 4 pieces are cut inside a head."""
    from repro_torch.configs.shapes import InputShape

    layout = {"node": 1, "fsdp": 2, "model": 4}
    shape = InputShape("serve_small", 32, 4, kind)
    cfg = get_config("stablelm-1.6b", "smoke")
    got = dryrun.sharded_serving(cfg, shape, kind, layout, 4)
    assert got["by_use"] == _serving_bytes(cfg, layout, kind, 4, 32)
    assert got["gathered_over_model"] == []
    assert got["per_device_memory"]["peak_bytes"] > 0
    qwen = dryrun.sharded_serving(get_config("qwen3-14b", "smoke"), shape, kind, layout, 4)
    assert qwen["gathered_over_model"] == [f"groups/0/0_attn/attn/{w}"
                                           for w in ("wq", "wk", "wv")]


def _tp_train_bytes(cfg, layout, m, batch, seq):
    """The counted bytes a device of a dense GQA arch's tensor-parallel PaME
    step moves over `layout` = (1, f, t), f or t = 1, by kind and use, in
    the parameters' type (e bytes an element), for m nodes on the rank, R =
    batch / (m f) rows a node on a rank, S tokens a row and L layers:

      * over `model` (t > 1), per node: the forward's sums of wo's and
        w_down's partial outputs and the backward's sums of the gradient of
        each layer's attention and MLP input and of the head's input, 2 (4L
        + 1) R S d e ("activations"); the embedding's lookup, 2 R S d e
        ("embed"); the logits' vocab slices gathered, R S V 4 ("logits");
      * over fsdp (f > 1), per node: every fsdp-placed leaf gathered once a
        use, its bytes ("weights"; the tied embedding twice), its gradient
        reduce-scattered, its bytes over f ("gradient"); the leaves not
        placed over fsdp (the 2L + 1 norms [d]) summed, 2 x their bytes
        ("gradient"); the loss's f32 sum over the rows' ranks, 8
        ("activations");
      * the consensus scalar summed over the axis of more than one rank, 8
        ("metrics"); the exchange over one node, and the losses and sigma
        gathered over it, 0 bytes."""
    from repro_torch import sharding as shd
    from repro_torch.tree import tree_leaves

    f, t = layout["fsdp"], layout["model"]
    e = 4 if cfg.dtype == "float32" else 2
    rows, d, lay = batch // (m * f), cfg.d_model, cfg.n_layers
    out = {"all_gather": {"exchange": 0, "metrics": 0}, "all_reduce": {"metrics": 8}}
    if t > 1:
        out["all_gather"]["logits"] = m * rows * seq * cfg.vocab * 4
        out["all_reduce"].update(activations=m * 2 * (4 * lay + 1) * rows * seq * d * e,
                                 embed=m * 2 * rows * seq * d * e)
    if f > 1:
        params = dryrun.abstract_params(cfg)
        specs = shd.params_shardings(params, layout, node_stacked=False)
        placed = replicated = 0
        for leaf, spec in zip(tree_leaves(params), shd.leaf_specs(params, specs)):
            if any("fsdp" in shd.spec_axes(entry) for entry in spec):
                uses = 2 if spec == specs["embed"] and cfg.tie_embeddings else 1
                placed += uses * leaf.numel() * e
            else:
                replicated += leaf.numel() * e
        assert replicated == (2 * lay + 1) * d * e
        out["all_gather"]["weights"] = m * placed
        out["reduce_scatter"] = {"gradient": m * placed // f}
        out["all_reduce"].update(gradient=m * 2 * replicated, activations=m * 8)
    return out


@pytest.mark.parametrize("layout", [{"node": 1, "fsdp": 1, "model": 4},
                                    {"node": 1, "fsdp": 4, "model": 1}])
def test_tp_train_collectives_follow_a_formula(layout):
    """The tensor-parallel PaME step (`lm_grad_fn` takes a view) of
    stablelm-smoke, 4 nodes on one rank, at (1, 1, 4) and (1, 4, 1): its
    collective bytes by kind and by use are `_tp_train_bytes`', and no
    gradient is gathered: it is reduce-scattered."""
    cfg = get_config("stablelm-1.6b", "smoke")
    shape = _small(seq=32, batch=16)
    got = dryrun.sharded_collectives(cfg, shape, layout, 16, m=M)
    want = _tp_train_bytes(cfg, layout, M, 16, 32)
    assert got["by_use"] == want
    assert got["bytes"] == {k: sum(v.values()) for k, v in want.items()}
    assert "gradient" not in got["by_use"]["all_gather"]


def test_train_record_memory_below_the_gather_whole_route(tmp_path):
    """The CLI's smoke train record at --devices 8 --model-axis 4 carries
    ``per_device_memory``, one rank's trace of the tensor-parallel step;
    its peak is below the one-card step's and below the gather-whole
    route's at the same layout, and the record's gradient is
    reduce-scattered, not gathered."""
    from repro_torch.launch.train import lm_grad_fn

    out = tmp_path / "dry.json"
    (rec,) = dryrun.main(["--arch", "stablelm-1.6b", "--size", "smoke", "--shape", "train_4k",
                          "--batch", "16", "--device-bytes", "8e10", "--devices", "8",
                          "--model-axis", "4", "--out", str(out)]).values()
    layout = {k: rec["layout"][k] for k in ("node", "fsdp", "model")}
    assert layout == {"node": 2, "fsdp": 1, "model": 4}
    dev = rec["per_device_memory"]["peak_bytes"]
    assert 0 < dev < rec["memory"]["peak_bytes"]
    assert rec["collective_bytes_by_use"]["all_reduce"]["activations"] > 0
    assert "gradient" not in rec["collective_bytes_by_use"]["all_gather"]
    cfg = dryrun._resolve("stablelm-1.6b", "train_4k", size="smoke")[1]
    whole = lm_grad_fn(cfg)
    gw = dryrun.sharded_collectives(cfg, INPUT_SHAPES["train_4k"], layout, 16,
                                    grad_fn=lambda p, b, k: whole(p, b, k))
    assert dev < gw["per_device_memory"]["peak_bytes"]
    assert gw["by_use"]["all_gather"]["gradient"] > 0
