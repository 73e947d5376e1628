"""One-card dry run: every (arch x shape) step sized without allocating
(port of `repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k [--nodes 4] [--devices 8] [--model-axis 1] [--device-bytes 80e9]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The JAX dry run lowers and compiles each step for a TPU mesh and reads
XLA's memory and cost analyses.  This one builds the same steps as eager
PyTorch on fake tensors (`torch._subclasses.FakeTensorMode`: shapes and
types, no storage) and counts their operations with
`torch.utils.flop_counter.FlopCounterMode`:

  * train: one PaME step (the dense exchange, Bernoulli masks, remat on)
    of m = ``--nodes`` node models, all on the one card, at the shape's
    global batch split over the m nodes;
  * prefill: `prefill(params, cfg, batch, cache_capacity)`;
  * decode: one `decode_step` on `input_specs`' cache.

Each record holds the parameter and active-parameter counts; the bytes of
the parameters, the node-stacked state, the inputs and the cache; the
step's FLOPs; its memory; whether it fits in the card's memory; the
(node, fsdp, model) layout of ``--devices`` cards of this kind
(`launch.mesh`, model axis ``--model-axis``, default 1: the port's choice
for an 80 GB card, where JAX's `make_logical_mesh` reads its TPU pod's
``MODEL_AXIS`` of 16) with what each would hold under
`repro_torch.sharding`'s placements; and the step's collective bytes over
that layout.

  * FLOPs: kernels are reached through their plain versions on non-CUDA
    tensors, so masked attention counts whole [S, S] score blocks; a
    prefill record also gives the count with each GQA layer's attention
    cut to the causal (or window) band the flash kernel computes.
  * ``memory``: the counterpart of JAX's ``compiled.memory_analysis()``,
    from a second trace of the same fake-tensor step under
    `torch.distributed._tools.mem_tracker.MemTracker`, with every kernel
    wrapper on its kernel's route (`repro_torch.kernels.fake_route`: the
    outputs and temporaries the launch would allocate, no [S, S] scores
    where flash runs).  ``argument_bytes`` are the step's inputs (the
    state or parameters, the batch, a decode's cache), ``output_bytes``
    what it returns, ``peak_bytes`` the most bytes live at once and
    ``temp_bytes`` = peak − argument bytes.  A trace sees what each op
    returns but not the temporaries its CUDA code allocates inside the
    launch; `CUDA_TEMPS` adds those that `tools/memory_probe.py` found on
    the card (the plain attention's softmax backward, the loss's
    logsumexp, a bf16 mean's f32 sums) at the moment the op runs.
    ``code_bytes`` is None: no executable is compiled.  ``fits_one_card``
    compares the peak with the card; ``resident_bytes`` stays beside it.  ``mem_trace_s`` is the
    trace's host time.  The ``kernels`` variant sets ``use_flash`` and
    ``use_ssd_kernel``, as the card's serving paths run (JAX's configs
    and dry run leave both off; this variant is the port's own).
  * ``collective_bytes``: JAX's record parses them from the partitioned
    HLO (`parse_collective_bytes`); the port has no HLO.  A train record
    runs the sharded PaME step (`core.pame`, ``param_shardings=``,
    tensor-parallel over `model` with each layer gathered over fsdp, as
    `launch.train.lm_grad_fn` takes a view) as rank 0 of a world of
    ``--devices`` ranks under torch's fake process group, on fake tensors,
    with m = the layout's node count (JAX's choice) and the global batch
    split over them, and records what `repro_torch.sharding`'s counted
    collectives moved, by kind, per device, with JAX's convention
    (`collective_bytes`, the counterpart of `parse_collective_bytes`), the
    same bytes by use (``collective_bytes_by_use``: "exchange", "weights"
    (the layers' gathers over fsdp), "activations" (the sums over `model`
    forward and backward), "gradient" (the reduce-scatters over fsdp and
    the sums of the leaves not placed over fsdp), "metrics") and
    ``per_device_memory``, that rank's trace of the step.  A prefill or
    decode record runs the sharded serving step (`prefill` / `decode_step`
    with ``shardings=``, `sharding.
    serving_shardings` at the layout) the same way, with the step's own
    global batch: its collective bytes by kind and by use ("weights": the
    per-layer gathers over fsdp and the fallback gathers over model;
    "activations", "embed", "logits", "cache", "routing"), the leaves it gathered over
    `model` (``gathered_over_model``) and ``per_device_memory``, one rank's
    memory from a `MemTracker` trace of that step (on the kernels' route, as
    ``memory``).

The card's memory comes from ``torch.cuda.get_device_properties(0)``, or
from ``--device-bytes`` (what a CPU run needs); with neither, the run
raises.  The per-device parameter budget of the layout is half of it, as
JAX's 16 GB chip gets an 8 GB budget.  Results accumulate in a JSON file
(``--out``, default ``build/dryrun/dryrun.json`` at the repository root,
git-ignored), keyed by arch, shape, cut and variant, so an interrupted
sweep resumes.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding as shd
from repro_torch.kernels import fake_route
from repro_torch.configs import all_arch_names, get_config
from repro_torch.configs.shapes import (
    INPUT_SHAPES,
    InputShape,
    cache_capacity,
    config_for_shape,
    input_specs,
)
from repro_torch.core.pame import (PaMEConfig, PaMEState, make_topology_arrays, pame_step,
                                   shard_batch)
from repro_torch.core.topology import build_topology
from repro_torch.launch.mesh import logical_layout, make_logical_mesh
from repro_torch.launch.train import lm_grad_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, init_cache, init_params, layer_groups, prefill
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["abstract_params", "build_train", "train_state_specs", "probe_depths",
           "VARIANTS", "band_pairs", "attention_flops", "step_specs", "step_bytes", "count_flops",
           "trace_memory", "CUDA_TEMPS", "collective_bytes", "sharded_collectives",
           "sharded_serving", "run_combo", "results_path", "ARTIFACTS", "main"]

FLOPS_NOTE = ("counted on the plain versions: masked attention counts whole [S, S] "
              "score blocks")
MEMORY_NOTE = ("live bytes of a trace on fake tensors (MemTracker) on the route each kernel "
               "takes on the card, with CUDA_TEMPS' in-launch temporaries; code_bytes: no "
               "counterpart, nothing is compiled")
COLLECTIVE_NOTE = ("per device: rank 0 of the sharded PaME step (tensor-parallel over model, "
                   "each layer gathered over fsdp), by kind, with JAX's convention (an "
                   "all-gather counts its result, g x its input; a reduce-scatter its result; "
                   "an all-reduce 2 x its tensor); collective_bytes_by_use splits them by what "
                   "they carry; per_device_memory is that rank's trace")
SERVING_NOTE = ("per device: rank 0 of the sharded serving step, by kind and by use, with "
                "JAX's convention; gathered_over_model lists the leaves whose pieces do not "
                "line up with the heads, columns or experts a rank computes; "
                "per_device_memory is that rank's trace")
# the directory of the dry run's results (`results_path`), git-ignored
ARTIFACTS = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")


def _tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _meta_like(tree):
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)


def abstract_params(cfg: ModelConfig):
    """`init_params`' tree as meta tensors (shapes and types), nothing
    allocated: the counterpart of ``jax.eval_shape(init_params)``."""
    with FakeTensorMode():
        return _meta_like(init_params(0, cfg, device="cpu"))


# ---------------------------------------------------------------------------
# the steps sized
# ---------------------------------------------------------------------------
def build_train(cfg: ModelConfig, m: int, exchange: str = "dense", device="cpu",
                param_shardings=None, *, pame_cfg: Optional[PaMEConfig] = None,
                grad_fn=None):
    """One PaME step of m node models with the JAX dry run's settings (ring
    topology, Bernoulli masks, every node exchanging at step 0; or
    `pame_cfg`), on `device`; sharded over `param_shardings` (a
    `sharding.MeshShardings`) when it is given, as JAX's ``step(...,
    param_shardings=)``.  The LM's `lm_grad_fn` takes a view, so the
    sharded step runs tensor-parallel; a `grad_fn` without one takes the
    gather-whole route."""
    topo = build_topology("ring", m) if m > 2 else build_topology("complete", max(m, 2))
    pcfg = pame_cfg or PaMEConfig(nu=0.5, p=0.2, gamma=1.001, sigma0=5.0,
                                  mask_mode="bernoulli", homogeneous_kappa=4, exchange=exchange)
    topo_arrays = make_topology_arrays(topo, pcfg, device=device)
    grad_fn = grad_fn or lm_grad_fn(cfg)

    def step(state, batch):
        return pame_step(state, batch, grad_fn, topo_arrays, pcfg,
                         param_shardings=param_shardings)

    return step


def train_state_specs(cfg: ModelConfig, m: int) -> PaMEState:
    """The node-stacked PaME state as meta tensors."""
    stacked = tree_map(lambda s: torch.empty((m,) + tuple(s.shape), dtype=s.dtype,
                                             device="meta"), abstract_params(cfg))
    return PaMEState(params=stacked, sigma=torch.empty((m,), device="meta"), step=0, key=0)


def _materialize(tree):
    """Fake tensors (inside the active FakeTensorMode) for meta stand-ins."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype)
                    if isinstance(x, torch.Tensor) else x, tree)


def probe_depths(cfg: ModelConfig) -> tuple:
    """Two reduced depths at full width, as JAX's dry run probes them (it
    needs them to count a scanned layer; here every layer is counted, and
    the probes give the cost of one more layer)."""
    if cfg.arch_type == "hybrid":
        return (cfg.attn_every, 2 * cfg.attn_every)
    if cfg.arch_type == "moe":
        fd = cfg.first_dense_layers
        return (fd + 2, fd + 4)
    return (2, 4)


# named variants: model-config overrides, the PaME exchange mode and
# placement-rule overrides (through sharding.RULE_OVERRIDES), as JAX's
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "compressed": {"exchange": "compressed"},
    "remat_dots": {"remat_policy": "dots"},
    "compressed+dots": {"exchange": "compressed", "remat_policy": "dots"},
    "chunked2048": {"prefill_chunk": 2048},
    "chunked512": {"prefill_chunk": 512},
    "chunked512+dots": {"prefill_chunk": 512, "remat_policy": "dots"},
    "embed_vocab_only": {"_rules": {"embed": ("model", None)}},
    "embed_vocab_only+compressed": {
        "_rules": {"embed": ("model", None)}, "exchange": "compressed",
    },
    "mamba_nosplit_shard": {
        "_rules": {
            "mamba/in_proj": ("fsdp", None),
            "mamba/out_proj": (None, "fsdp"),
            "mamba/conv_w": (None, None),
            "mamba/conv_b": (None,),
        }
    },
    "mamba_split_proj": {"ssm_split_proj": True},
    "compressed_q8": {"exchange": "compressed_q8"},
    # the port's own: the kernels the card's serving paths run (flash and SSD)
    "kernels": {"use_flash": True, "use_ssd_kernel": True},
}


def band_pairs(seq: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal attention over `seq` rows scores, each
    row i seeing min(i + 1, window) keys (all i + 1 without a window)."""
    w = min(window or seq, seq)
    return w * (w + 1) // 2 + (seq - w) * w


def attention_flops(cfg: ModelConfig, batch: int, seq: int) -> Optional[Dict[str, int]]:
    """A prefill's GQA attention operations (q.k and p.v), counted over
    whole [S, S] blocks ("full") and over the causal or window band the
    flash kernel computes ("band"); None for MLA, which flash never runs."""
    if cfg.use_mla or cfg.arch_type == "ssm":
        return None
    sites = sum(g.repeat * sum(k in ("attn", "shared_block") for k in g.pattern)
                for g in layer_groups(cfg))
    per_pair = 4 * batch * cfg.n_heads * cfg.head_dim
    return {"full": sites * per_pair * seq * seq,
            "band": sites * per_pair * band_pairs(seq, cfg.window)}


# ---------------------------------------------------------------------------
# one combo
# ---------------------------------------------------------------------------
def _per_device(cfg: ModelConfig, shape: InputShape, kind: str, layout: Dict[str, int]):
    """What each device of `layout` holds for the real shape (placements
    from `repro_torch.sharding`), or None when the layout has no node."""
    if layout["node"] < 1:
        return None
    if kind == "train" and shape.kind != "train":
        return None  # a train step exists at the train shape only
    specs = step_specs(cfg, shape, kind, shape.global_batch, layout["node"])
    stacked = kind == "train"
    if stacked:
        place = shd.state_shardings(specs["state"], layout)
        out = {"state": shd.per_device_bytes(specs["state"].params, place.params, layout)
               + shd.per_device_bytes(specs["state"].sigma, place.sigma, layout)}
    else:
        out = {"params": shd.per_device_bytes(
            specs["params"], shd.params_shardings(specs["params"], layout, node_stacked=False),
            layout)}
    out["inputs"] = shd.per_device_bytes(
        specs["inputs"], shd.batch_shardings(specs["inputs"], layout, node_stacked=stacked),
        layout)
    if specs["cache"] is not None:
        out["cache"] = shd.per_device_bytes(specs["cache"],
                                            shd.cache_shardings(specs["cache"], layout), layout)
    out["total"] = sum(out.values())
    return out


def _resolve(arch: str, shape_name: str, *, variant: str = "baseline", remat: bool = True,
             probe_layers: Optional[int] = None, kind: Optional[str] = None,
             size: str = "full"):
    """(base config, step config, shape, kind, exchange) of one combo; sets
    the variant's placement overrides."""
    shape = INPUT_SHAPES[shape_name]
    kind = kind or shape.kind
    base = get_config(arch, size)
    cfg = config_for_shape(base, shape)
    overrides = dict(VARIANTS[variant])
    exchange = overrides.pop("exchange", "dense")
    shd.RULE_OVERRIDES.clear()
    shd.RULE_OVERRIDES.update(overrides.pop("_rules", {}))
    if overrides:
        cfg = cfg.replace(**overrides)
    if probe_layers is not None:
        cfg = cfg.replace(n_layers=probe_layers, unroll=True)
    if kind == "train" and remat:
        cfg = cfg.replace(remat=True)
    return base, cfg, shape, kind, exchange


def step_specs(cfg: ModelConfig, shape: InputShape, kind: str, global_batch: int,
               nodes: int) -> Dict[str, object]:
    """The meta stand-ins a step of `kind` takes at `global_batch` (from
    `input_specs`): "params" (train: the node-stacked "state"), "inputs"
    and "cache" (a prefill's is the cache it returns)."""
    run = InputShape(shape.name, shape.seq_len, global_batch, kind)
    if kind == "train":
        if global_batch % nodes:
            raise ValueError(f"global batch {global_batch} does not split over {nodes} nodes")
        return {"state": train_state_specs(cfg, nodes),
                "inputs": input_specs(cfg, run, m_nodes=nodes), "cache": None}
    specs = input_specs(cfg, run)
    if kind == "prefill":
        cache = init_cache(cfg, global_batch, cache_capacity(cfg, shape), device="meta")
        return {"params": abstract_params(cfg), "inputs": specs, "cache": cache}
    return {"params": abstract_params(cfg), "inputs": {"token": specs["token"]},
            "cache": specs["cache"]}


def step_bytes(specs: Dict[str, object]) -> Dict[str, int]:
    """Bytes of each part of `step_specs`' stand-ins."""
    out = {"input_bytes": _tree_bytes(specs["inputs"]),
           "cache_bytes": _tree_bytes(specs["cache"]) if specs["cache"] is not None else 0}
    if "state" in specs:
        out["state_bytes"] = _tree_bytes(specs["state"])
        out["param_bytes"] = _tree_bytes(specs["state"].params) // specs["state"].sigma.shape[0]
    else:
        out["param_bytes"] = _tree_bytes(specs["params"])
    return out


def _step_call(cfg: ModelConfig, shape: InputShape, kind: str, specs: Dict[str, object],
               exchange: str):
    """(arguments, fn): fake tensors made from `specs` (inside the active
    FakeTensorMode) and the call of one step on them."""
    if kind == "train":
        state, batch = _materialize(specs["state"]), _materialize(specs["inputs"])
        step = build_train(cfg, state.sigma.shape[0], exchange=exchange)
        return (state, batch), lambda: step(state, batch)
    if kind == "prefill":
        params, batch = _materialize(specs["params"]), _materialize(specs["inputs"])
        cap = cache_capacity(cfg, shape)
        return (params, batch), lambda: prefill(params, cfg, batch, cap)
    params, batch, cache = (_materialize(specs[k]) for k in ("params", "inputs", "cache"))
    pos = shape.seq_len  # the token after a full cache
    return (params, batch, cache), lambda: decode_step(params, cfg, batch["token"], pos, cache)


def count_flops(cfg: ModelConfig, shape: InputShape, kind: str, specs: Dict[str, object],
                exchange: str = "dense") -> int:
    """Operations of one step on fake tensors made from `specs`
    (FlopCounterMode: matrix products and convolutions)."""
    with FakeTensorMode():
        _, fn = _step_call(cfg, shape, kind, specs, exchange)
        with torch.inference_mode(kind != "train"), FlopCounterMode(display=False) as fc:
            fn()
    return int(fc.get_total_flops())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# ops whose CUDA code holds a temporary beside its inputs and outputs while
# it runs (`tools/memory_probe.py` on the card, torch 2.11): the bytes, from
# the op's arguments and output
CUDA_TEMPS = {
    # softmax's backward: a buffer of its output's size
    "aten._softmax_backward_data.default": lambda args, out: _nbytes(out),
    # logsumexp: self - max(self), the input's size
    "aten.logsumexp.default": lambda args, out: _nbytes(args[0]),
    # the mean of a bf16 / f16 tensor: its sums in f32
    "aten.mean.dim": lambda args, out: (out.numel() * 4
                                        if args[0].dtype in (torch.bfloat16, torch.float16)
                                        else 0),
}


class _CudaTemps(TorchDispatchMode):
    """Inside a `MemTracker`: the most bytes live while an op of
    `CUDA_TEMPS` runs, its temporary on top of what is live after it."""

    def __init__(self, tracker):
        super().__init__()
        self.tracker = tracker
        self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = CUDA_TEMPS.get(str(func))
        if rule is not None:
            live = sum(snap["Total"] for snap in self.tracker.get_tracker_snapshot().values())
            self.peak = max(self.peak, live + rule(args, out))
        return out


def _unique_bytes(tree) -> int:
    """Bytes of the distinct storages under `tree`'s tensors."""
    seen = {}
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace_memory(cfg: ModelConfig, shape: InputShape, kind: str, specs: Dict[str, object],
                 exchange: str = "dense") -> Dict[str, Optional[int]]:
    """The step's memory (see the module's docstring): a trace on fake
    tensors under `MemTracker`, each kernel wrapper on its kernel's route."""
    with FakeTensorMode(), fake_route.kernel_route():
        args, fn = _step_call(cfg, shape, kind, specs, exchange)
        return _traced(args, fn, kind != "train")


def _traced(args, fn, inference: bool) -> Dict[str, Optional[int]]:
    """The memory of ``fn()`` (inside the caller's fake-tensor mode) whose
    inputs are `args`: `MemTracker`'s peak, or more where an op of
    `CUDA_TEMPS` runs."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    tracker.track_external(*[x for x in tree_leaves(args) if isinstance(x, torch.Tensor)])
    temps = _CudaTemps(tracker)
    with torch.inference_mode(inference), tracker, temps:
        out = fn()
    peak = max(temps.peak, sum(snap["Total"]
                               for snap in tracker.get_tracker_snapshot("peak").values()))
    argument = _unique_bytes(args)
    output = _unique_bytes(out)
    del out, args, fn, tracker
    return {"argument_bytes": argument, "output_bytes": output,
            "temp_bytes": peak - argument, "peak_bytes": peak, "code_bytes": None}


def collective_bytes(counts: Dict[str, Dict[str, float]]) -> Dict[str, int]:
    """The counterpart of JAX's ``parse_collective_bytes`` (which sums the
    result bytes of each collective in XLA's partitioned HLO text, an
    all-reduce twice): bytes by kind from `repro_torch.sharding`'s counted
    collectives (`sharding.collective_counts()`), per device."""
    return {kind: int(round(c["bytes"])) for kind, c in sorted(counts.items())}


def _counted(counts: Dict[str, Dict[str, object]]) -> Dict[str, object]:
    """Bytes by kind (both kinds, 0 where none was issued), by use, and the
    calls, from `sharding.collective_counts()`."""
    counts = {kind: counts.get(kind, {"calls": 0, "bytes": 0, "by_use": {}})
              for kind in ("all_gather", "all_reduce", *counts)}
    return {"bytes": collective_bytes(counts),
            "by_use": {k: {u: int(round(b)) for u, b in sorted(c["by_use"].items())}
                       for k, c in sorted(counts.items())},
            "calls": {k: int(c["calls"]) for k, c in sorted(counts.items())}}


def sharded_collectives(cfg: ModelConfig, shape: InputShape, layout: Dict[str, int],
                        global_batch: int, exchange: str = "dense", *, m: Optional[int] = None,
                        pame_cfg: Optional[PaMEConfig] = None,
                        grad_fn=None) -> Dict[str, object]:
    """One sharded PaME step over `layout` as rank 0 of a fake process
    group of its size, on fake tensors with every kernel wrapper on its
    kernel's route: m nodes (default layout["node"]), the global batch
    split over them, `build_train`'s step (`pame_cfg`, `grad_fn`; default
    the tensor-parallel LM step).  Returns the bytes by kind and by use, the
    calls and ``per_device_memory``, that rank's `MemTracker` trace of the
    step (see the module's docstring)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = layout["node"] * layout["fsdp"] * layout["model"]
    m = m or layout["node"]
    if dist.is_initialized():
        raise RuntimeError("the collective trace needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = make_logical_mesh(device_type="cpu", layout=layout)
        specs = step_specs(cfg, shape, "train", global_batch, m)
        place = shd.state_shardings(specs["state"], layout)
        sharded = shd.MeshShardings(mesh, place.params)
        coord = shd.mesh_coords(mesh)
        step = build_train(cfg, m, exchange=exchange, param_shardings=sharded,
                           pame_cfg=pame_cfg, grad_fn=grad_fn)
        grad_fn = grad_fn or lm_grad_fn(cfg)
        # the mesh's own index tensors are real (its groups are looked up
        # inside the step); every tensor of the step is fake
        with FakeTensorMode(allow_non_fake_inputs=True), fake_route.kernel_route():
            state = shd.shard_tree(_materialize(specs["state"]), place, layout, coord)
            batch = shard_batch(_materialize(specs["inputs"]), sharded, grad_fn)
            shd.reset_collective_counts()
            memory = _traced((state, batch), lambda: step(state, batch), False)
            counts = shd.collective_counts()
            del state, batch
    finally:
        dist.destroy_process_group()
    return dict(_counted(counts), m=m, per_device_memory=memory)


def sharded_serving(cfg: ModelConfig, shape: InputShape, kind: str, layout: Dict[str, int],
                    global_batch: int) -> Dict[str, object]:
    """One sharded prefill or decode step over `layout` as rank 0 of a fake
    process group of its size, on fake tensors with every kernel wrapper on
    its kernel's route: the rank's pieces of the parameters
    (`sharding.serving_shardings`), its rows of the batch and of the
    caches.  Returns the collective bytes by kind and by use, the calls,
    the leaves gathered over `model` and the rank's memory (see the
    module's docstring)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = layout["node"] * layout["fsdp"] * layout["model"]
    if dist.is_initialized():
        raise RuntimeError("the collective trace needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        mesh = make_logical_mesh(device_type="cpu", layout=layout)
        coord = shd.mesh_coords(mesh)
        specs = step_specs(cfg, shape, kind, global_batch, layout["node"])
        # the mesh's own index tensors are real; every tensor of the step is fake
        with FakeTensorMode(allow_non_fake_inputs=True), fake_route.kernel_route():
            params, inputs, cache = (_materialize(specs[k]) for k in ("params", "inputs",
                                                                      "cache"))
            sh = shd.serving_shardings(mesh, params, inputs, cache)
            params = shd.shard_tree(params, sh.params, layout, coord)
            inputs = shd.shard_tree(inputs, sh.batch, layout, coord)
            if kind == "prefill":
                cap = cache_capacity(cfg, shape)
                args = (params, inputs)
                fn = lambda: prefill(params, cfg, inputs, cap, shardings=sh)  # noqa: E731
            else:
                cache = shd.shard_tree(cache, sh.caches, layout, coord)
                args = (params, inputs, cache)
                fn = lambda: decode_step(params, cfg, inputs["token"], shape.seq_len,  # noqa: E731
                                         cache, shardings=sh)
            shd.reset_collective_counts()
            memory = _traced(args, fn, True)
            counts, gathered = shd.collective_counts(), shd.gathered_over_model()
            del params, inputs, cache, args, fn
    finally:
        dist.destroy_process_group()
    return dict(_counted(counts), gathered_over_model=gathered, per_device_memory=memory)


def run_combo(
    arch: str,
    shape_name: str,
    *,
    device_bytes: float,
    nodes: int = 4,
    devices: int = 8,
    remat: bool = True,
    probe_layers: Optional[int] = None,
    variant: str = "baseline",
    batch: Optional[int] = None,
    kind: Optional[str] = None,
    size: str = "full",
    model_axis: int = 1,
) -> Dict:
    """Size one (arch x shape) step.  `batch` cuts the global batch (named
    in the record's ``reduced``), `kind` runs another step than the
    shape's own (a long_500k prefill), `size` picks the config ("smoke"
    for tests), `model_axis` the layout's tensor-parallel width."""
    base, cfg, shape, kind, exchange = _resolve(
        arch, shape_name, variant=variant, remat=remat, probe_layers=probe_layers, kind=kind,
        size=size)
    # the layout follows the full-depth config, so that probes land on the
    # layout they stand for
    layout = logical_layout(config_for_shape(base, shape), devices, model_axis=model_axis,
                            param_budget=device_bytes / 2)
    gb = batch or shape.global_batch
    specs = step_specs(cfg, shape, kind, gb, nodes)
    rec = {"arch": arch, "size": size, "shape": shape_name, "kind": kind, "variant": variant,
           "probe_layers": probe_layers, "n_layers": cfg.n_layers, "seq_len": shape.seq_len,
           "global_batch": gb, "window": cfg.window,
           "param_count": base.param_count(), "active_param_count": base.active_param_count(),
           **step_bytes(specs),
           "tokens": gb * (1 if kind == "decode" else shape.seq_len)}
    if kind == "train":
        rec["m"] = nodes
    else:
        rec["capacity"] = cache_capacity(cfg, shape)
    if gb != shape.global_batch:
        rec["reduced"] = {"global_batch": [shape.global_batch, gb]}
    t0 = time.perf_counter()
    rec["flops"] = count_flops(cfg, shape, kind, specs, exchange)
    rec["trace_s"] = time.perf_counter() - t0
    rec["flops_note"] = FLOPS_NOTE
    if kind == "prefill":
        att = attention_flops(cfg, gb, shape.seq_len)
        if att is not None:
            rec["attention_flops"] = att
            rec["flops_band"] = rec["flops"] - att["full"] + att["band"]
    t0 = time.perf_counter()
    rec["memory"] = trace_memory(cfg, shape, kind, specs, exchange)
    rec["mem_trace_s"] = time.perf_counter() - t0
    rec["memory_note"] = MEMORY_NOTE
    resident = (rec["state_bytes"] if kind == "train" else rec["param_bytes"]) \
        + rec["input_bytes"] + rec["cache_bytes"]
    rec.update(resident_bytes=resident, device_bytes=device_bytes,
               fits_one_card=rec["memory"]["peak_bytes"] <= device_bytes)
    rec["layout"] = dict(layout, devices=devices)
    rec["per_device_bytes"] = _per_device(cfg, shape, kind, layout)
    rec["collective_bytes"] = rec["collective_bytes_total"] = None
    if layout["node"] < 1:
        rec["collective_note"] = f"{devices} devices do not hold a model axis of {model_axis}"
    elif kind != "train":
        t0 = time.perf_counter()
        coll = sharded_serving(cfg, shape, kind, layout, gb)
        rec.update(collective_bytes=coll["bytes"],
                   collective_bytes_total=sum(coll["bytes"].values()),
                   collective_bytes_by_use=coll["by_use"], collective_calls=coll["calls"],
                   gathered_over_model=coll["gathered_over_model"],
                   per_device_memory=coll["per_device_memory"],
                   collective_trace_s=time.perf_counter() - t0, collective_note=SERVING_NOTE)
    elif gb % layout["node"]:
        rec["collective_note"] = f"the global batch {gb} does not split over the layout's nodes"
    else:
        t0 = time.perf_counter()
        coll = sharded_collectives(cfg, shape, layout, gb, exchange)
        rec.update(collective_bytes=coll["bytes"],
                   collective_bytes_total=sum(coll["bytes"].values()),
                   collective_bytes_by_use=coll["by_use"],
                   collective_calls=coll["calls"], collective_m=coll["m"],
                   per_device_memory=coll["per_device_memory"],
                   collective_trace_s=time.perf_counter() - t0,
                   collective_note=COLLECTIVE_NOTE)
    tag = f"L{probe_layers}" if probe_layers else "full"
    coll = rec["collective_bytes_total"]
    dev_peak = rec.get("per_device_memory", {}).get("peak_bytes")
    print(f"[dryrun] {arch} x {shape_name} ({kind}, batch {gb}) [{tag}/{variant}] "
          f"params={rec['param_bytes'] / 1e9:.2f}GB resident={resident / 1e9:.2f}GB "
          f"peak={rec['memory']['peak_bytes'] / 1e9:.2f}GB "
          f"fits={rec['fits_one_card']} flops={rec['flops']:.3e} "
          f"layout@{devices}={layout} coll={'-' if coll is None else f'{coll:.3e}'} "
          f"peak@device={'-' if dev_peak is None else f'{dev_peak / 1e9:.2f}GB'} "
          f"trace={rec['trace_s']:.1f}s mem_trace={rec['mem_trace_s']:.1f}s", flush=True)
    return rec


def results_path() -> str:
    return os.path.join(ARTIFACTS, "dryrun.json")


def card_bytes(device_bytes: Optional[float]) -> float:
    """`device_bytes` if given, else the card's total memory; raises when
    there is neither (no budget is guessed)."""
    if device_bytes is not None:
        return float(device_bytes)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device to read the memory of: pass --device-bytes")
    return float(torch.cuda.get_device_properties(0).total_memory)


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="redo cached records")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also size the two reduced-depth probes of each combo")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--nodes", type=int, default=4,
                    help="DFL nodes of a train step, all on the one card")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the global batch to N (recorded under 'reduced')")
    ap.add_argument("--kind", default=None, choices=["train", "prefill", "decode"],
                    help="size this step instead of the shape's own")
    ap.add_argument("--devices", type=int, default=8,
                    help="cards of the per-device layout report")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the layout's tensor-parallel width (JAX's MODEL_AXIS)")
    ap.add_argument("--device-bytes", type=float, default=None,
                    help="one card's memory (default: read from the card)")
    ap.add_argument("--size", default="full", choices=["full", "smoke"],
                    help="the configs' full or smoke variant")
    ap.add_argument("--out", default=None, help="results JSON (default: build/dryrun/)")
    return ap


def main(argv=None) -> Dict[str, Dict]:
    args = make_parser().parse_args(argv)
    device_bytes = card_bytes(args.device_bytes)
    archs = all_arch_names() if (args.all or args.arch in (None, "all")) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape in (None, "all")) else [args.shape]
    path = args.out or results_path()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    results: Dict[str, Dict] = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    failures = []
    for arch in archs:
        for shape in shapes:
            depth_list = [None]
            if args.probes:
                depth_list += list(probe_depths(get_config(arch, args.size)))
            for depth in depth_list:
                key = "|".join(str(x) for x in (
                    arch, args.size, shape, args.kind or INPUT_SHAPES[shape].kind,
                    f"b{args.batch or INPUT_SHAPES[shape].global_batch}", f"m{args.nodes}",
                    f"d{args.devices}", f"t{args.model_axis}",
                    f"L{depth}" if depth else "full", args.variant))
                if key in results and not args.force:
                    print(f"[dryrun] skip cached {key}", flush=True)
                    continue
                try:
                    results[key] = run_combo(
                        arch, shape, device_bytes=device_bytes, nodes=args.nodes,
                        devices=args.devices,
                        remat=not args.no_remat, probe_layers=depth, variant=args.variant,
                        batch=args.batch, kind=args.kind, size=args.size,
                        model_axis=args.model_axis)
                    with open(path, "w") as f:
                        json.dump(results, f, indent=1)
                except Exception as e:  # noqa: BLE001 - the sweep goes on
                    failures.append((key, repr(e)[:500]))
                    print(f"[dryrun] FAIL {key}: {e!r}", flush=True)
    print(f"[dryrun] done: {len(results)} cached in {path}, {len(failures)} failures")
    for k, e in failures:
        print("  FAIL", k, e)
    if failures:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
