"""Baseline DFL algorithms the paper compares against, Sec. V-D (port of
`repro.core.baselines`):

  * D-PSGD      (Lian et al., 2017)       — gossip + local SGD
  * DFedSAM     (Shi et al., 2023)        — SAM local step + gossip
  * CHOCO-SGD   (Koloskova et al., 2020)  — compressed gossip, error feedback
  * BEER        (Zhao et al., 2022)       — compressed gradient tracking
  * (AN)Q-NIDS  (Michelusi et al., 2022)  — NIDS with quantized messages

All operate on node-stacked pytrees [m, ...] and a doubly-stochastic mixing
matrix B (Assumption 1), given as `b`: a raw [m, m] tensor (plain einsum)
or a `repro_torch.core.mixing.Mixer`, whose "sparse" and "dense" modes run
through the gossip kernel on the card.

The results are JAX's; where the work happens differs, so that a
full-width model fits one card:

  * *Local work node by node.*  Gradients are taken one node at a time (as
    `repro_torch.core.pame.pame_step` does), so one node's activations and
    gradient are alive at once; DFedSAM's ascent chain is local to a node.
  * *Cross-node work leaf by leaf, in place.*  Mixing, compression and the
    axpys run one leaf at a time and update the state's tensors in place,
    so no transient exceeds a few leaves.  A step therefore CONSUMES its
    input state, as JAX's scan donates its carry: the caller rebinds to
    the returned state and never reads the old one again
    (`repro_torch.core.engine` clones the state first when its stop rule
    may need the pre-step state).
  * *Distinct storage for every state field* (`stack_params` copies; the
    zero buffers and BEER's g / prev_grad are separate tensors), so the
    in-place updates of one field never reach another.

Where the in-place order changes the order of additions, the step says so;
those differ from JAX by rounding only.  Per-node keys come from
`fold_in(key, i)` instead of JAX's `split(key, m)` (the LM and regression
losses ignore them).  Every step takes ``draws=``, the per-leaf uniforms
of each compression in JAX's leaf order (each leaf's [m, n] tensor, or its
shape), drawn otherwise from `fold_in(fold_in(key, tag), leaf_index)`
generators with JAX's tags (BEER 3 and 5, CHOCO 7, NIDS 11).
Every step also runs lane-batched (`core.lanes`): a state whose key and
step are int64 arrays [L] holds L lanes folded into its L·m rows, each
lane with its own keys, its own swept hyperparameters (per-lane tuples)
and its own loss mean, and the mixer's tables keep the lanes apart.
``grad_shift`` (bounded staleness: `core.algorithms`' temporal and fault
steps) moves each delayed node's gradient point from its delayed
parameters e_i back to e_i + (f_i − e_i), the fresh point in JAX's
rounding, node by node: a `GradShift` holds the rows of the delayed nodes
only (a punctual node's shift is zero and is not stored), and a tree of
[m, ...] leaves, JAX's form, is taken too.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import lanes as LN
from repro_torch.core.compression import Compressor
from repro_torch.core.mixing import Mixer, as_mixer
from repro_torch.core.pme import fold_in, make_generator
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

# grad_fn(params_i, batch_i, key_i) -> (loss_i, grads_i), key_i an int seed
GradFn = Callable[[object, object, int], Tuple[torch.Tensor, object]]
MixOp = Union[torch.Tensor, Mixer]

__all__ = [
    "DPSGDState", "dpsgd_init", "dpsgd_step",
    "DFedSAMState", "dfedsam_init", "dfedsam_step",
    "ChocoState", "choco_init", "choco_step",
    "BeerState", "beer_init", "beer_step",
    "NidsState", "nids_init", "nids_step",
    "stack_params", "run_algorithm", "GradShift",
]


def stack_params(params0, m: int):
    """m copies of a single-node pytree, each in storage of its own."""
    return tree_map(lambda x: x.unsqueeze(0).repeat((m,) + (1,) * x.dim()), params0)


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def _start(key):
    """(step 0, key) of a new state: ints, or int64 arrays [L] for a
    lane-batched state's per-lane keys."""
    if LN.count(key) is None:
        return 0, int(key)
    key = np.asarray(key, dtype=np.int64)
    return np.zeros_like(key), key


class GradShift:
    """Per-node gradient-point shifts, JAX's ``grad_shift`` tree (fresh −
    delayed parameters) kept as the rows of the nodes it moves:
    ``rows[i]`` is node i's list of leaf rows in JAX leaf order; a node
    without an entry is punctual (zero shift).  `from_stacked` keeps the
    moved rows of each leaf as one tensor as well (``index``, the rows'
    indices on the leaves' device, and ``stacked``, one [n, ...] tensor a
    leaf), and ``rows`` are views of it."""

    def __init__(self, rows: dict):
        self.rows = rows
        self.index = self.stacked = None

    @classmethod
    def from_stacked(cls, nodes: Sequence[int], index: torch.Tensor,
                     stacked: Sequence[torch.Tensor]) -> "GradShift":
        shift = cls({i: [t[j] for t in stacked] for j, i in enumerate(nodes)})
        shift.index, shift.stacked = index, list(stacked)
        return shift


def _as_shift(grad_shift, n_leaves: int) -> Optional[GradShift]:
    """None, a `GradShift`, or a tree of [m, ...] leaves (every node's
    rows), checked against the parameters' leaf count."""
    if grad_shift is None:
        return None
    if not isinstance(grad_shift, GradShift):
        leaves = tree_leaves(grad_shift)
        grad_shift = GradShift({i: [x[i] for x in leaves] for i in range(leaves[0].shape[0])})
    for i, rows in grad_shift.rows.items():
        if len(rows) != n_leaves:
            raise ValueError(f"grad_shift has {len(rows)} leaves for node {i}; "
                             f"the parameters have {n_leaves}")
    return grad_shift


def _point(rows: Sequence[torch.Tensor], shift: Optional[GradShift], i: int):
    """Node i's gradient point: its rows, plus its shift when it has one
    (JAX's ``_shifted``: x + (f − e) in the leaves' type)."""
    if shift is None or i not in shift.rows:
        return list(rows)
    with torch.no_grad():
        return [x + s.to(x.dtype) for x, s in zip(rows, shift.rows[i])]


def _node_grad(grad_fn: GradFn, leaves: Sequence[torch.Tensor], treedef, batch,
               i: int, key: int):
    """(loss, gradient leaves) of node i (its batch row; the node's index
    within its lane) at the single-node `leaves`."""
    p_i = tree_unflatten(treedef, [x.detach().requires_grad_(True) for x in leaves])
    b_i = tree_map(lambda b: b[i], batch)
    loss, g = grad_fn(p_i, b_i, key)
    return loss.detach().float().reshape(()), [t.detach() for t in tree_leaves(g)]


def _rows(leaves, key):
    """(rows, nodes a lane) of stacked `leaves` under `key`."""
    rows = leaves[0].shape[0]
    return rows, rows // (LN.count(key) or 1)


def _grads_inplace(grad_fn, leaves, treedef, batch, key, lr, shift=None):
    """x_i ← x_i − lr·grad f_i(x_i + shift_i), row by row, in place on the
    stacked `leaves` (row r's gradient reads only its own rows), with each
    lane's key and lr.  Returns the per-row losses."""
    losses = []
    rows, m = _rows(leaves, key)
    for r in range(rows):
        loss, g = _node_grad(grad_fn, _point([x[r] for x in leaves], shift, r), treedef,
                             batch, r % m, LN.node_key(key, r, m))
        losses.append(loss)
        step = -LN.lane_value(lr, r // m)
        with torch.no_grad():
            for x, gi in zip(leaves, g):
                x[r].add_(gi.to(x.dtype) * step)
        del g
    return losses


def _generators(key, idx: int, u, rows: int, device):
    """Row r's generator for leaf `idx`: its lane's, seeded with
    fold_in(lane key, idx) and drawn in row order (None when `u` is given)."""
    if u is not None:
        return [None] * rows
    m = rows // (LN.count(key) or 1)
    gens = [make_generator(fold_in(LN.lane_key(key, lane), idx), device)
            for lane in range(rows // m)]
    return [gens[r // m] for r in range(rows)]


def _add_compressed_(comp: Compressor, key, idx: int, target: torch.Tensor,
                     source: torch.Tensor, u=None) -> None:
    """target += C(source − target), one node's message (row) at a time, in
    place; leaf `idx`'s uniforms from `u` ([rows, ...]) or drawn from
    fold_in(key, idx) (each lane from its own key)."""
    m = target.shape[0]
    t2, s2 = target.view(m, -1), source.reshape(m, -1)
    gens = _generators(key, idx, u, m, target.device)
    for r in range(m):
        ur = None if u is None else u[r].reshape(1, -1)
        t2[r].add_(comp.apply((s2[r] - t2[r])[None], u=ur, generator=gens[r])[0])


def _compressed_diff(comp: Compressor, key: int, idx: int, source: torch.Tensor,
                     target: torch.Tensor, u=None) -> torch.Tensor:
    """C(source − target) as a new tensor, one node's message (row) at a
    time, with leaf `idx`'s uniforms drawn as `_add_compressed_` draws
    them (the replicated fault steps need the innovation itself)."""
    m = target.shape[0]
    s2, t2 = source.reshape(m, -1), target.reshape(m, -1)
    out = torch.empty_like(t2)
    gens = _generators(key, idx, u, m, target.device)
    for r in range(m):
        ur = None if u is None else u[r].reshape(1, -1)
        out[r] = comp.apply((s2[r] - t2[r])[None], u=ur, generator=gens[r])[0]
    return out.view(target.shape)


def _compress_tree(comp: Compressor, key: int, tree, draws=None):
    """C applied to every node's row of every leaf (JAX's `_compress_tree`):
    leaf idx compressed with fold_in(key, idx), or with draws[idx]."""
    leaves, treedef = tree_flatten(tree)
    out = []
    for idx, leaf in enumerate(leaves):
        acc = torch.zeros_like(leaf)
        _add_compressed_(comp, key, idx, acc, leaf, None if draws is None else draws[idx])
        out.append(acc)
    return tree_unflatten(treedef, out)


def _draw(draws, name: str, idx: int):
    return None if draws is None else draws[name][idx]


def _mean(losses, key) -> torch.Tensor:
    return LN.lane_mean(losses, key)


# --------------------------------------------------------------------------
# D-PSGD
# --------------------------------------------------------------------------
class DPSGDState(NamedTuple):
    params: object
    step: int
    key: int


def dpsgd_init(key, params_stacked) -> DPSGDState:
    step, key = _start(key)
    return DPSGDState(params_stacked, step, key)


def dpsgd_step(state: DPSGDState, batch, grad_fn: GradFn, b: MixOp, lr: float,
               grad_shift=None, *, draws=None) -> Tuple[DPSGDState, dict]:
    """x ← B x − lr·grad f(x): the mixed tree first (new tensors), then each
    node's gradient at the old x (shifted by `grad_shift`), subtracted in
    place."""
    mx = as_mixer(b)
    key = LN.fold(state.key, state.step)
    leaves, treedef = tree_flatten(state.params)
    shift = _as_shift(grad_shift, len(leaves))
    new = [mx.mix(x) for x in leaves]
    losses = []
    rows, m = _rows(leaves, key)
    for r in range(rows):
        loss, g = _node_grad(grad_fn, _point([x[r] for x in leaves], shift, r), treedef,
                             batch, r % m, LN.node_key(key, r, m))
        losses.append(loss)
        step = -LN.lane_value(lr, r // m)
        with torch.no_grad():
            for y, gi in zip(new, g):
                y[r].add_(gi.to(y.dtype) * step)
    return (DPSGDState(tree_unflatten(treedef, new), state.step + 1, state.key),
            {"loss_mean": _mean(losses, key)})


# --------------------------------------------------------------------------
# DFedSAM — sharpness-aware local step, then gossip
# --------------------------------------------------------------------------
class DFedSAMState(NamedTuple):
    params: object
    step: int
    key: int


def dfedsam_init(key, params_stacked) -> DFedSAMState:
    step, key = _start(key)
    return DFedSAMState(params_stacked, step, key)


def dfedsam_step(state: DFedSAMState, batch, grad_fn: GradFn, b: MixOp, lr: float,
                 rho: float = 0.05, local_steps: int = 1, grad_shift=None, *,
                 draws=None) -> Tuple[DFedSAMState, dict]:
    """Per node, `local_steps` SAM steps (g1 at x, ascent to x + ρ·g1/‖g1‖,
    x −= lr·g2 with g2 at the ascent point), in place; then x ← B x.
    ‖g1‖ is summed over the leaves in the leaves' type, as in JAX.  A
    `grad_shift` is constant through the chain: g1 is taken at x + shift
    and the ascent starts there, as in JAX."""
    mx = as_mixer(b)
    key = LN.fold(state.key, state.step)
    leaves, treedef = tree_flatten(state.params)
    shift = _as_shift(grad_shift, len(leaves))
    losses = []
    rows, m = _rows(leaves, key)
    for r in range(rows):
        lane, i = divmod(r, m)
        k_lane = LN.lane_key(key, lane)
        rho_l, step = LN.lane_value(rho, lane), -LN.lane_value(lr, lane)
        p = [x[r] for x in leaves]  # views: the local chain updates the state
        for t in range(local_steps):
            k_t = fold_in(k_lane, t)
            gp = _point(p, shift, r)
            loss, g1 = _node_grad(grad_fn, gp, treedef, batch, i, fold_in(k_t, i))
            if t == 0:
                losses.append(loss)
            with torch.no_grad():
                sq = sum(torch.sum(g ** 2) for g in g1)
                scale = rho_l / torch.sqrt(sq + 1e-12)
                adv = [x + g.to(x.dtype) * scale.to(x.dtype) for x, g in zip(gp, g1)]
            del g1, gp
            _, g2 = _node_grad(grad_fn, adv, treedef, batch, i, fold_in(fold_in(k_t, 1), i))
            del adv
            with torch.no_grad():
                for x, g in zip(p, g2):
                    x.add_(g.to(x.dtype) * step)
            del g2
    new = [mx.mix(x) for x in leaves]
    return (DFedSAMState(tree_unflatten(treedef, new), state.step + 1, state.key),
            {"loss_mean": _mean(losses, key)})


# --------------------------------------------------------------------------
# CHOCO-SGD — compressed gossip with error feedback
# --------------------------------------------------------------------------
class ChocoState(NamedTuple):
    params: object   # x_i
    hats: object     # \hat x_i (public surrogates, consistent across nodes)
    step: int
    key: int


def choco_init(key, params_stacked) -> ChocoState:
    step, key = _start(key)
    return ChocoState(params_stacked, _zeros(params_stacked), step, key)


def choco_step(state: ChocoState, batch, grad_fn: GradFn, b: MixOp, lr: float,
               comp: Compressor, gossip_gamma: float = 0.5, grad_shift=None, *,
               draws=None) -> Tuple[ChocoState, dict]:
    """x^{t+1/2} = x − lr·g (node by node, in place); then per leaf
    x̂ += C(x^{t+1/2} − x̂) and x = x^{t+1/2} + γ(B x̂ − x̂).
    ``draws={"q": [u per leaf]}`` (JAX tag 7)."""
    mx = as_mixer(b)
    key = LN.fold(state.key, state.step)
    leaves, treedef = tree_flatten(state.params)
    hats = tree_leaves(state.hats)
    losses = _grads_inplace(grad_fn, leaves, treedef, batch, key, lr,
                            _as_shift(grad_shift, len(leaves)))
    k_q = LN.fold(key, 7)
    with torch.no_grad():
        for idx, (x, h) in enumerate(zip(leaves, hats)):
            _add_compressed_(comp, k_q, idx, h, x, _draw(draws, "q", idx))
            corr = mx.mix(h)
            x.add_(LN.scale_(corr.sub_(h), gossip_gamma, key))
            del corr
    return (ChocoState(state.params, state.hats, state.step + 1, state.key),
            {"loss_mean": _mean(losses, key)})


# --------------------------------------------------------------------------
# BEER — compressed gradient tracking (O(1/T) nonconvex rate)
# --------------------------------------------------------------------------
class BeerState(NamedTuple):
    params: object  # x
    h: object       # surrogate of x
    g: object       # gradient tracker
    z: object       # surrogate of g
    prev_grad: object
    step: int
    key: int


def _stacked_grads(grad_fn, params_stacked, batch, key):
    """Every node's gradient at its own rows, stacked like the params."""
    leaves, treedef = tree_flatten(params_stacked)
    out = [torch.empty_like(x) for x in leaves]
    rows, m = _rows(leaves, key)
    for r in range(rows):
        _, g = _node_grad(grad_fn, [x[r] for x in leaves], treedef, batch, r % m,
                          LN.node_key(key, r, m))
        with torch.no_grad():
            for o, gi in zip(out, g):
                o[r].copy_(gi)
    return tree_unflatten(treedef, out)


def beer_init(key, params_stacked, batch0, grad_fn: GradFn) -> BeerState:
    step, key = _start(key)
    g0 = _stacked_grads(grad_fn, params_stacked, batch0, key)
    return BeerState(params_stacked, _zeros(params_stacked), g0,
                     _zeros(params_stacked), tree_map(torch.clone, g0), step, key)


def beer_step(state: BeerState, batch, grad_fn: GradFn, b: MixOp, lr: float,
              comp: Compressor, gossip_gamma: float = 0.4, grad_shift=None, *,
              draws=None) -> Tuple[BeerState, dict]:
    """BEER in place, in an order that keeps the five trees and one node's
    gradient alive:

      1. per leaf: x += γ(B − I)h − lr·g, then h += C(x − h);
      2. per leaf: g += γ(B − I)z − prev_grad;
      3. per node i: gn_i at the new x_i, g_i += gn_i, prev_grad_i ← gn_i;
      4. per leaf: z += C(g − z).

    JAX sums g + γ(B − I)z + gn − prev_grad left to right; here prev_grad
    is subtracted before gn is added, which changes the rounding only.
    ``draws={"h": [...], "z": [...]}`` (JAX tags 3 and 5)."""
    mx = as_mixer(b)
    key = LN.fold(state.key, state.step)
    xs, treedef = tree_flatten(state.params)
    shift = _as_shift(grad_shift, len(xs))
    hs, gs, zs, ps = (tree_leaves(t) for t in (state.h, state.g, state.z, state.prev_grad))
    k_h, k_z = LN.fold(key, 3), LN.fold(key, 5)
    with torch.no_grad():
        for idx, (x, h, g) in enumerate(zip(xs, hs, gs)):
            mh = mx.mix_lazy(h)
            x.add_(LN.scale_(mh, gossip_gamma, key)).sub_(LN.scaled(g, lr, key))
            del mh
            _add_compressed_(comp, k_h, idx, h, x, _draw(draws, "h", idx))
        for z, g, gp in zip(zs, gs, ps):
            mz = mx.mix_lazy(z)
            g.add_(LN.scale_(mz, gossip_gamma, key)).sub_(gp)
            del mz
    losses = []
    rows, m = _rows(xs, key)
    for r in range(rows):
        loss, gn = _node_grad(grad_fn, _point([x[r] for x in xs], shift, r), treedef, batch,
                              r % m, LN.node_key(key, r, m))
        losses.append(loss)
        with torch.no_grad():
            for g, gp, gi in zip(gs, ps, gn):
                g[r].add_(gi.to(g.dtype))
                gp[r].copy_(gi)
        del gn
    with torch.no_grad():
        for idx, (z, g) in enumerate(zip(zs, gs)):
            _add_compressed_(comp, k_z, idx, z, g, _draw(draws, "z", idx))
    return (BeerState(state.params, state.h, state.g, state.z, state.prev_grad,
                      state.step + 1, state.key),
            {"loss_mean": _mean(losses, key)})


# --------------------------------------------------------------------------
# (AN)Q-NIDS — NIDS with (adaptively) quantized messages
# --------------------------------------------------------------------------
class NidsState(NamedTuple):
    params: object  # x^k
    c: object       # running sum of the adapt steps z^s, s < k (memory)
    hat_z: object   # public surrogate of z (quantized innovations)
    hat_c: object   # public surrogate of c (receiver-side accumulation)
    step: int
    key: int


def nids_init(key, params_stacked, batch0=None, grad_fn: Optional[GradFn] = None,
              lr=None) -> NidsState:
    """All memory starts at zero (the drop-aware form needs no warm-up
    gradient); ``batch0`` / ``grad_fn`` / ``lr`` are accepted and ignored,
    as in JAX."""
    del batch0, grad_fn, lr
    step, key = _start(key)
    return NidsState(params_stacked, _zeros(params_stacked), _zeros(params_stacked),
                     _zeros(params_stacked), step, key)


def nids_step(state: NidsState, batch, grad_fn: GradFn, b: MixOp, lr: float,
              comp: Optional[Compressor] = None, grad_shift=None, *,
              draws=None) -> Tuple[NidsState, dict]:
    r"""Drop-aware NIDS (exact-diffusion family), Ã = (I + B)/2:

        z^k     = x^k − lr grad^k                       (adapt)
        x^{k+1} = z^k + (Ã − I)(2 z^k + c^k)            (correct + combine)
        c^{k+1} = c^k + z^k                             (memory)

    With comp != None this is (AN)Q-NIDS: nodes transmit the quantized
    innovation q = Q(z − ẑ), both ends update the public surrogates
    (ẑ += q, ĉ += ẑ), and (Ã − I)v is taken with the lossy surrogates
    off the diagonal and each node's exact v on it.  See
    `repro.core.baselines.nids_step` for the derivation.  Here z is formed
    in place in x node by node, then each leaf is corrected in place.
    ``draws={"q": [...]}`` (JAX tag 11)."""
    mx = as_mixer(b)
    key = LN.fold(state.key, state.step)
    xs, treedef = tree_flatten(state.params)
    cs, hzs, hcs = (tree_leaves(t) for t in (state.c, state.hat_z, state.hat_c))
    losses = _grads_inplace(grad_fn, xs, treedef, batch, key, lr,
                            _as_shift(grad_shift, len(xs)))  # x holds z now
    k_q = LN.fold(key, 11)
    with torch.no_grad():
        for idx, (z, c, hz, hc) in enumerate(zip(xs, cs, hzs, hcs)):
            v = 2.0 * z + c
            if comp is not None:
                _add_compressed_(comp, k_q, idx, hz, z, _draw(draws, "q", idx))
                hat_v = 2.0 * hz + hc  # the new ẑ with the old ĉ
                hc.add_(hz)
                corr = mx.mix_nids_quantized(hat_v, v)
                del hat_v
                corr.sub_(v)
            else:
                corr = 0.5 * mx.mix_lazy(v)
            del v
            c.add_(z)
            z.add_(corr)
            del corr
    return (NidsState(state.params, state.c, state.hat_z, state.hat_c,
                      state.step + 1, state.key),
            {"loss_mean": _mean(losses, key)})


# --------------------------------------------------------------------------
# Generic driver
# --------------------------------------------------------------------------
# the dynamic-network metrics run_algorithm's history keeps per step (JAX's
# list minus the serving-pacing ones, which are not ported)
_OPTIONAL_METRICS = (
    "wire_bits", "alive_nodes", "stale_nodes",
    "col_defect", "mean_drift", "dropped_msgs", "crashed_nodes",
    "repair_bits", "surrogate_desync",
    "queue_depth", "served_reqs", "deferred_nodes",
    "comp_consensus", "comp_mean_gap",
)


def run_algorithm(
    step_fn: Callable,  # (state, batch[, k][, aux]) -> (state, metrics[, aux])
    state,
    batch_fn: Callable[[int], object],
    num_steps: int,
    objective_fn: Optional[Callable] = None,
    params_of=lambda s: s.params,
    tol_std: float = 1e-3,
    driver: str = "scan",
    chunk_size: int = engine.DEFAULT_CHUNK_SIZE,
    step_takes_index: bool = False,
    carries_aux: bool = False,
    aux=None,
) -> Tuple[object, dict]:
    """Race driver shared by every baseline.

    driver="scan" runs `chunk_size` steps per host sync through
    `repro_torch.core.engine`, with the std stop rule evaluated on the
    device; driver="host" is the per-step loop.  `step_takes_index=True`
    feeds the global step index as a third step argument on both;
    `carries_aux=True` threads `aux` (the temporal or fault carry) as the
    last argument and takes it back as the step's third result.  Per-step
    ``stale_hist`` rows become the run's ``staleness_hist``, and the
    dynamic-network metrics of `_OPTIONAL_METRICS` a step emits are kept
    per step under their names (JAX's history schema).
    """
    if driver == "scan":
        state, metrics, info = engine.run_scan_loop(
            step_fn, state, batch_fn, num_steps, objective_fn=objective_fn,
            params_of=params_of, tol_std=tol_std, chunk_size=chunk_size,
            step_takes_index=step_takes_index, carries_aux=carries_aux, aux=aux,
        )
        history = engine.history_from(
            metrics, info, {"loss": "loss_mean", "objective": "objective"})
        _extra_metrics(history, metrics)
        return state, history
    if driver != "host":
        raise ValueError(f"unknown driver {driver!r}")
    if carries_aux and aux is None:
        raise ValueError("carries_aux needs aux=aux0")
    history = {"loss": [], "objective": []}
    rows: dict = {}
    f_window: list = []
    for k in range(num_steps):
        args = (state, batch_fn(k)) + ((k,) if step_takes_index else ())
        if carries_aux:
            state, metrics, aux = step_fn(*args, aux)
        else:
            state, metrics = step_fn(*args)
        history["loss"].append(float(metrics["loss_mean"]))
        for key, val in metrics.items():
            if key in _OPTIONAL_METRICS or key == "stale_hist":
                rows.setdefault(key, []).append(torch.as_tensor(val).detach().cpu().numpy())
        if objective_fn is not None:
            mean_params = tree_map(lambda x: x.mean(dim=0), params_of(state))
            fval = float(objective_fn(mean_params))
            history["objective"].append(fval)
            f_window.append(fval)
            if len(f_window) >= 3 and float(np.std(f_window[-3:])) < tol_std:
                break
    history["steps_run"] = history["steps_dispatched"] = len(history["loss"])
    _extra_metrics(history, {key: np.stack(v) for key, v in rows.items()})
    return state, history


def _extra_metrics(history: dict, metrics: dict) -> None:
    """The `_OPTIONAL_METRICS` a run emitted into `history`, per step, and
    its ``stale_hist`` rows summed into ``staleness_hist``."""
    for key, vals in metrics.items():
        if key == "stale_hist":
            history["staleness_hist"] = engine.staleness_hist(vals)
        elif key in _OPTIONAL_METRICS:
            history[key] = [float(v) for v in vals]
