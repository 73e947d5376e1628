"""Chunked execution engine for iterative DFL algorithms (port of the
runner of `repro.core.engine.make_scan_runner`).

JAX runs `chunk_size` steps per dispatch inside one `lax.scan`.  The port
runs the same chunk as an eager Python loop over the step function and
keeps what made the scan cheap:

  * per-step metrics stay on the device, and the host reads a whole chunk
    back with ONE transfer at the chunk boundary (the only sync per chunk);
  * the paper's std stop rule (stop when std{f(w^{k-2}), f(w^{k-1}),
    f(w^k)} < tol) is evaluated on the device on a rolling 3-value window;
    once it fires, every later step of the chunk is a no-op through a
    per-tensor `torch.where` select, so the returned state is exactly the
    triggering step's although the chunk ran to its length.  Host-side
    leaves of the state (PaME's integer step counter) cannot be selected
    on the device; the engine records them per step and restores the
    triggering step's values after the chunk's sync.
  * a step may update its input state in place (the baselines do, as
    JAX's scan donates its carry); under the stop rule the engine hands
    the step a clone, so the frozen state survives the steps after it.

CUDA-graph capture of a chunk is later work.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["make_scan_runner", "run_scan_loop", "history_from", "DEFAULT_CHUNK_SIZE"]

DEFAULT_CHUNK_SIZE = 32


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


def _select(pred: torch.Tensor, on_true, on_false):
    """Per-tensor `where(pred, on_true, on_false)`; other leaves keep
    on_false's value (the engine restores them after the chunk)."""
    return tree_map(
        lambda t, f: torch.where(pred, t, f) if isinstance(f, torch.Tensor) else f,
        on_true, on_false,
    )


def _clone(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


def _host_leaves(state) -> list:
    return [x for x in tree_flatten(state)[0] if not isinstance(x, torch.Tensor)]


def _with_host_leaves(state, host: list):
    leaves, treedef = tree_flatten(state)
    it = iter(host)
    return tree_unflatten(
        treedef, [x if isinstance(x, torch.Tensor) else next(it) for x in leaves]
    )


def make_scan_runner(
    step_fn: Callable,  # (state, batch[, k]) -> (state, metrics dict of 0-d tensors)
    *,
    objective_fn: Optional[Callable] = None,
    params_of: Callable = lambda s: s.params,
    tol_std: float = 1e-3,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
    step_takes_index: bool = False,
) -> Callable[..., Tuple[object, dict, dict]]:
    """Build a reusable chunked driver.

    Returns ``run(state, batch_fn, num_steps, *, copy_state=True,
    k_start=0) -> (state, metrics, info)``: ``metrics`` maps each metric
    key (plus ``"objective"`` when `objective_fn` is given) to a host
    array of length ``info["steps_run"]``; ``info["steps_dispatched"]``
    counts the steps executed (chunk-rounded past an early stop).
    ``step_takes_index=True`` passes the global step index as a third step
    argument; ``k_start`` offsets it for callers that drive chunks one by
    one (the training CLI).  ``copy_state=True`` clones the caller's
    tensors first, so a step that updates its input in place cannot touch
    them; callers that rebind to the returned state pass False.
    """

    def run(state, batch_fn: Callable[[int], object], num_steps: int, *,
            copy_state: bool = True, k_start: int = 0):
        if copy_state:
            state = _clone(state)
        done = win = None
        keys: list = []
        rows: list = []  # per step: metric tensors in `keys` order + stopped flag
        host_per_step: list = []
        k0, end = k_start, k_start + num_steps
        stopped_at = None
        while k0 < end:
            length = min(chunk_size, end - k0)
            chunk_rows = []
            for k in range(k0, k0 + length):
                step_state = state if objective_fn is None else _clone(state)
                args = (step_state, batch_fn(k)) + ((k,) if step_takes_index else ())
                new_state, metrics = step_fn(*args)
                del step_state
                ys = dict(metrics)
                if objective_fn is not None:
                    mean_params = tree_map(lambda x: x.mean(dim=0), params_of(new_state))
                    obj = torch.as_tensor(objective_fn(mean_params)).float().reshape(())
                    if done is None:
                        done = torch.zeros((), dtype=torch.bool, device=obj.device)
                        win = torch.zeros(3, dtype=torch.float32, device=obj.device)
                    new_win = torch.cat([win[1:], obj[None]])
                    # the rule needs three values of *this* run in the window
                    trigger = (torch.std(new_win, correction=0) < tol_std) & (k - k_start >= 2)
                    # a step after the rule fired is a no-op: keep the frozen
                    # state so the returned state is the triggering step's
                    state = _select(done, state, new_state)
                    win = torch.where(done, win, new_win)
                    done = done | trigger
                    ys["objective"] = obj
                    ys["_stopped"] = done
                else:
                    state = new_state
                if not keys:
                    keys = list(ys)
                    dev = torch.as_tensor(ys[keys[0]]).device
                chunk_rows.append(torch.stack([
                    torch.as_tensor(ys[key], dtype=torch.float32, device=dev).reshape(())
                    for key in keys
                ]))
                host_per_step.append(_host_leaves(state))
            # one transfer per chunk boundary: the only mid-run readback
            block = torch.stack(chunk_rows).cpu().numpy()
            rows.append(block)
            k0 += length
            if objective_fn is not None and block[-1, keys.index("_stopped")]:
                stopped_at = len(host_per_step) - length + int(
                    np.argmax(block[:, keys.index("_stopped")] > 0))
                break
        if not rows:
            return state, {}, {"steps_run": 0, "steps_dispatched": 0}
        table = np.concatenate(rows)
        host = {key: table[:, c] for c, key in enumerate(keys)}
        stopped = host.pop("_stopped", None)
        if stopped_at is not None:
            state = _with_host_leaves(state, host_per_step[stopped_at])
        steps_run = (
            int(np.argmax(stopped > 0)) + 1
            if stopped is not None and stopped.any() else len(table)
        )
        metrics = {key: val[:steps_run] for key, val in host.items()}
        return state, metrics, {
            "steps_run": steps_run, "steps_dispatched": k0 - k_start,
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
):
    """One-shot convenience wrapper over `make_scan_runner`."""
    runner = make_scan_runner(
        step_fn, objective_fn=objective_fn, params_of=params_of,
        tol_std=tol_std, chunk_size=chunk_size, step_takes_index=step_takes_index,
    )
    return runner(state, batch_fn, num_steps)
