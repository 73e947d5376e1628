"""Chunked execution engine for iterative DFL algorithms (port of the
runner of `repro.core.engine.make_scan_runner`).

JAX runs `chunk_size` steps per dispatch inside one `lax.scan`.  The port
runs the same chunk as an eager Python loop over the step function and
keeps what made the scan cheap:

  * per-step metrics stay where the step made them, and the host reads a
    whole chunk of device metrics back with ONE transfer at the chunk
    boundary (the only sync per chunk); metrics a step computes on the
    host (the dynamic-network realizations' counts) never touch the card;
  * the paper's std stop rule (stop when std{f(w^{k-2}), f(w^{k-1}),
    f(w^k)} < tol) is evaluated on the device on a rolling 3-value window;
    once it fires, every later step of the chunk is a no-op through a
    per-tensor `torch.where` select, so the returned state is exactly the
    triggering step's although the chunk ran to its length.  Leaves of the
    state (or of the auxiliary carry) that cannot be selected on the
    device — Python numbers such as PaME's step counter, and host tensors
    such as the Markov chains' state on a CUDA run — are recorded per step
    and the triggering step's values restored after the chunk's sync;
  * a step may update its input state in place (the baselines do, as
    JAX's scan donates its carry); under the stop rule the engine hands
    the step a clone, so the frozen state survives the steps after it;
  * ``run(Donated(state), ...)`` donates the state as JAX's runner does:
    the caller drops its own names for the state first, the runner takes
    the only reference, and the input tensors that the first step's
    outputs do not hold are freed when it returns, so that a chunk of
    several steps holds one state, not two.  Nothing is freed under the
    caller's feet: a view of the state kept elsewhere keeps its storage;
  * ``carries_aux=True`` threads an auxiliary carry (the temporal or
    fault Markov state and the staleness ring) through the steps, frozen
    by the same select;
  * ``lanes=L`` runs a lane-batched step (`core.algorithms.BatchedAlgorithm`:
    state leaves [L, m, ...], metrics [L]) with the stop rule per lane: the
    select is lane-wise, so a finished lane's state and carry stop moving
    while the others run on, host leaves (the per-lane step counters and
    keys) are restored per lane, and the chunk loop stops once every lane
    has stopped.  Metrics come back as [steps, L] and ``steps_run`` as an
    [L] array.

A metric may be a scalar or a vector (the temporal path's per-step
``stale_hist``, a lane-batched step's [L] values); each comes back as a
host array with one row per step.
CUDA-graph capture of a chunk is later work.

`setup_compilation_cache` is the persistent compilation cache: the port's
compile step is ``nvcc`` building its CUDA kernels, so the cache is the
directory their libraries go to.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["make_scan_runner", "run_scan_loop", "run_batched", "history_from",
           "staleness_hist", "Donated", "DEFAULT_CHUNK_SIZE", "setup_compilation_cache"]

DEFAULT_CHUNK_SIZE = 32


def setup_compilation_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Build (and look up) the CUDA kernels' libraries in `cache_dir`.

    A library's file name carries a hash of its source and headers, so a
    kernel built once in the directory is loaded from it by any later
    process, and an edited kernel is rebuilt beside the old one: the
    directory may be shared between checkouts and deleted wholesale at any
    time.  `cache_dir` defaults to the ``REPRO_COMPILE_CACHE`` environment
    variable; when neither is set nothing changes (the libraries go to the
    checkout's ``build/repro_torch_kernels/``) and None is returned.
    Returns the directory configured.  A kernel already loaded in this
    process stays loaded.
    """
    if cache_dir is None:
        cache_dir = os.environ.get("REPRO_COMPILE_CACHE")
    if not cache_dir:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = Path(cache_dir).resolve()
    return cache_dir


def history_from(metrics: dict, info: dict, keys: dict) -> dict:
    """Assemble a driver `history` dict from a runner's (metrics, info):
    `keys` maps history names to metric names; values become float lists."""
    history = {
        out: [float(v) for v in metrics.get(src, ())]
        for out, src in keys.items()
    }
    history["steps_run"] = info["steps_run"]
    history["steps_dispatched"] = info["steps_dispatched"]
    return history


def staleness_hist(rows) -> list:
    """Per-step ``stale_hist`` rows ([steps, D+1]) summed into the run's
    staleness histogram, the schema every driver logs."""
    return [float(v) for v in np.sum(np.asarray(rows), axis=0)]


def _on(x, device) -> bool:
    """A leaf the device-side select handles: a tensor on `device`."""
    return isinstance(x, torch.Tensor) and x.device == device


def _select(pred: torch.Tensor, on_true, on_false):
    """Per-tensor `where(pred, on_true, on_false)` for leaves on pred's
    device, a lane predicate [L] broadcast over each leaf's leading lane
    axis; other leaves keep on_false's value (the engine restores them
    after the chunk)."""

    def one(t, f):
        if not _on(f, pred.device):
            return f
        p = pred.reshape(tuple(pred.shape) + (1,) * (f.dim() - pred.dim()))
        return torch.where(p, t, f)

    return tree_map(one, on_true, on_false)


class Donated:
    """A state handed to a runner for good: ``box, state = Donated(state),
    None`` and then ``run(box, ...)``.  The runner takes the state out of
    the box (once), so its reference is the only one left."""

    __slots__ = ("_state",)

    def __init__(self, state):
        self._state = state

    def take(self):
        state, self._state = self._state, None
        if state is None:
            raise ValueError("a Donated state is taken once")
        return state


def _clone(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def _host_leaves(tree, device) -> list:
    return [x for x in tree_flatten(tree)[0] if not _on(x, device)]


def _with_host_leaves(tree, host: list, device):
    leaves, treedef = tree_flatten(tree)
    it = iter(host)
    return tree_unflatten(treedef, [x if _on(x, device) else next(it) for x in leaves])


def _restore_lanes(tree, per_step: list, stops: dict, device):
    """Each stopped lane l's entries of the host leaves back to their values
    after step ``stops[l]`` (host leaves with a leading lane axis: numpy
    arrays and host tensors; anything else is kept)."""
    leaves, treedef = tree_flatten(tree)
    out, j = [], 0
    for x in leaves:
        if _on(x, device):
            out.append(x)
            continue
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim:
            x = x.copy() if isinstance(x, np.ndarray) else x.clone()
            for lane, at in stops.items():
                x[lane] = per_step[at][j][lane]
        out.append(x)
        j += 1
    return tree_unflatten(treedef, out)


def _table(chunk: list, keys: list, device) -> dict:
    """A chunk's per-step metrics as host arrays, one row per step: the
    metrics on `device` stacked and read back in one transfer, the others
    stacked where they are."""
    out = {}
    for on_dev in (True, False):
        ks = [key for key in keys if _on(chunk[0][key], device) == on_dev]
        if not ks:
            continue
        rows = torch.stack([
            torch.cat([torch.as_tensor(ys[key]).reshape(-1).to(torch.float32) for key in ks])
            for ys in chunk
        ])
        block = rows.cpu().numpy()
        col = 0
        for key in ks:
            shape = tuple(torch.as_tensor(chunk[0][key]).shape)
            width = int(np.prod(shape))
            out[key] = block[:, col:col + width].reshape((len(chunk),) + shape)
            col += width
    return out


def make_scan_runner(
    step_fn: Callable,  # (state, batch[, k][, aux]) -> (state, metrics[, aux])
    *,
    objective_fn: Optional[Callable] = None,
    params_of: Callable = lambda s: s.params,
    tol_std: float = 1e-3,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    step_takes_index: bool = False,
    carries_aux: bool = False,
    lanes: Optional[int] = None,
    node_mean: Optional[Callable] = None,
) -> Callable[..., Tuple[object, dict, dict]]:
    """Build a reusable chunked driver.

    Returns ``run(state, batch_fn, num_steps, *, copy_state=True,
    k_start=0, aux=None) -> (state, metrics, info)``: ``metrics`` maps each
    metric key (plus ``"objective"`` when `objective_fn` is given) to a
    host array with one row per step, ``info["steps_run"]`` rows;
    ``info["steps_dispatched"]`` counts the steps executed (chunk-rounded
    past an early stop).  ``step_takes_index=True`` passes the global step
    index as a third step argument; ``k_start`` offsets it for callers
    that drive chunks one by one (the training CLI).  ``carries_aux=True``
    calls ``step_fn(state, batch, [k,] aux)``, which returns ``(state,
    metrics, aux)``; ``run(..., aux=aux0)`` seeds the carry and the last
    one comes back in ``info["aux"]``.  ``copy_state=True`` clones the
    caller's state (and carry) first, so a step that updates its input in
    place cannot touch them; callers that rebind to the returned values
    pass False, or hand the state over in a `Donated` box (no clone), so
    that it is freed after the first step.

    ``lanes=L`` expects a lane-batched step (state leaves [L, m, ...],
    metrics [L]); `objective_fn` stays the per-run callable and is applied
    to each lane's node-mean parameters.  Metrics come back as [steps, L]
    (every dispatched step: the lanes' lengths are ``info["steps_run"]``,
    an [L] int array).

    ``node_mean(params)`` replaces the node mean the objective is taken on:
    a sharded step's state holds a rank's pieces, and its mean is gathered
    whole over the ranks (`core.pame.make_pame_runner`), so that every rank
    reads the same objective and its stop rule fires at the same step.
    """

    def objective(params):
        if lanes is None:
            mean_params = (tree_map(lambda x: x.mean(dim=0), params) if node_mean is None
                           else node_mean(params))
            return torch.as_tensor(objective_fn(mean_params)).float().reshape(())
        # lane by lane, the arithmetic of an unbatched run
        return torch.stack([
            torch.as_tensor(objective_fn(tree_map(lambda x: x[lane].mean(dim=0), params)))
            .float().reshape(()) for lane in range(lanes)])

    def spread(win):
        if lanes is None:
            return torch.std(win, correction=0)
        return torch.stack([torch.std(w, correction=0) for w in win])

    def run(state, batch_fn: Callable[[int], object], num_steps: int, *,
            copy_state: bool = True, k_start: int = 0, aux=None):
        if carries_aux and aux is None:
            raise ValueError("carries_aux runner needs run(..., aux=aux0)")
        if isinstance(state, Donated):
            state = state.take()
        elif copy_state:
            state, aux = _clone(state), _clone(aux)
        done = win = dev = None
        keys: list = []
        blocks: list = []  # per chunk: {key: [steps, ...] host array}
        host_per_step: list = []
        k0, end = k_start, k_start + num_steps
        stopped_at = None
        while k0 < end:
            length = min(chunk_size, end - k0)
            chunk: list = []
            for k in range(k0, k0 + length):
                if objective_fn is None:
                    step_state, step_aux = state, aux
                else:
                    step_state, step_aux = _clone(state), _clone(aux)
                args = (step_state, batch_fn(k)) + ((k,) if step_takes_index else ())
                if carries_aux:
                    new_state, metrics, new_aux = step_fn(*args, step_aux)
                else:
                    new_state, metrics = step_fn(*args)
                    new_aux = aux
                del step_state, step_aux, args
                ys = dict(metrics)
                if dev is None:
                    dev = torch.as_tensor(ys["loss_mean"]).device
                if objective_fn is not None:
                    obj = objective(params_of(new_state))
                    dev = obj.device
                    if done is None:
                        done = torch.zeros(obj.shape, dtype=torch.bool, device=dev)
                        win = torch.zeros(tuple(obj.shape) + (3,), dtype=torch.float32,
                                          device=dev)
                    new_win = torch.cat([win[..., 1:], obj[..., None]], dim=-1)
                    # the rule needs three values of *this* run in the window
                    trigger = (spread(new_win) < tol_std) & (k - k_start >= 2)
                    # a step after the rule fired is a no-op: keep the frozen
                    # state so the returned state is the triggering step's
                    # (lane by lane)
                    state, aux = _select(done, (state, aux), (new_state, new_aux))
                    win = torch.where(done[..., None], win, new_win)
                    done = done | trigger
                    ys["objective"] = obj
                    ys["_stopped"] = done
                else:
                    state, aux = new_state, new_aux
                if not keys:
                    keys = list(ys)
                chunk.append(ys)
                host_per_step.append(_host_leaves((state, aux), dev))
            # one transfer per chunk boundary: the only mid-run readback
            block = _table(chunk, keys, dev)
            blocks.append(block)
            k0 += length
            # every lane stopped: the batched loop ends too
            if objective_fn is not None and np.all(block["_stopped"][-1]):
                break
        if not blocks:
            zero = 0 if lanes is None else np.zeros(lanes, np.int64)
            return state, {}, {"steps_run": zero, "steps_dispatched": 0, "aux": aux}
        host = {key: np.concatenate([b[key] for b in blocks]) for key in keys}
        stopped = host.pop("_stopped", None)
        n_steps = len(host_per_step)
        if lanes is not None:
            fired = np.zeros(lanes, bool) if stopped is None else (stopped > 0).any(axis=0)
            first = np.zeros(lanes, np.int64) if stopped is None else np.argmax(stopped > 0, axis=0)
            steps_run = np.where(fired, first + 1, n_steps).astype(np.int64)
            stops = {lane: int(first[lane]) for lane in range(lanes) if fired[lane]}
            if stops:
                state, aux = _restore_lanes((state, aux), host_per_step, stops, dev)
            return state, host, {
                "steps_run": steps_run, "steps_dispatched": k0 - k_start, "aux": aux,
            }
        if stopped is not None and stopped.any():
            stopped_at = int(np.argmax(stopped > 0))
            state, aux = _with_host_leaves((state, aux), host_per_step[stopped_at], dev)
        steps_run = n_steps if stopped_at is None else stopped_at + 1
        metrics = {key: val[:steps_run] for key, val in host.items()}
        return state, metrics, {
            "steps_run": steps_run, "steps_dispatched": k0 - k_start, "aux": aux,
        }

    return run


def run_scan_loop(
    step_fn: Callable,
    state,
    batch_fn: Callable[[int], object],
    num_steps: int,
    *,
    objective_fn: Optional[Callable] = None,
    params_of: Callable = lambda s: s.params,
    tol_std: float = 1e-3,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    step_takes_index: bool = False,
    carries_aux: bool = False,
    aux=None,
):
    """One-shot convenience wrapper over `make_scan_runner`."""
    runner = make_scan_runner(
        step_fn, objective_fn=objective_fn, params_of=params_of,
        tol_std=tol_std, chunk_size=chunk_size, step_takes_index=step_takes_index,
        carries_aux=carries_aux,
    )
    return runner(state, batch_fn, num_steps, aux=aux)


def run_batched(
    step_fn: Callable,  # lane-batched: state leaves [L, m, ...], metrics [L]
    state,
    batch_fn: Callable[[int], object],
    num_steps: int,
    *,
    lanes: int,
    objective_fn: Optional[Callable] = None,
    params_of: Callable = lambda s: s.params,
    tol_std: float = 1e-3,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    step_takes_index: bool = False,
    carries_aux: bool = False,
    aux=None,
):
    """One-shot lane-batched run: `make_scan_runner(lanes=lanes)` over a
    step that is already lane-batched (`Algorithm.bind_batched` builds one
    from any registered algorithm); per-lane [steps, L] metric buffers and
    ``info["steps_run"]`` [L]."""
    runner = make_scan_runner(
        step_fn, objective_fn=objective_fn, params_of=params_of, tol_std=tol_std,
        chunk_size=chunk_size, step_takes_index=step_takes_index,
        carries_aux=carries_aux, lanes=lanes,
    )
    return runner(state, batch_fn, num_steps, aux=aux)
