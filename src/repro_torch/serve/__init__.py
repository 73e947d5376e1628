"""Serve-while-train (port of `repro.serve`).

  * :mod:`repro_torch.serve.events` — per-node request arrival processes
    (Poisson and Markov-modulated bursts) and the :class:`ServePacing`
    round pacer that rides the engine's auxiliary carry.
  * :mod:`repro_torch.serve.serving` — :class:`ServeLoop`, batched greedy
    decode against each node's current model (or its component's mean)
    with per-node service cost.
  * :mod:`repro_torch.serve.membership` — elastic membership: joins with
    checkpoint catch-up, graceful leaves, chaos timelines.

The package exports JAX's event-layer names, and the serving loop's,
which the port's callers import from here; ``membership`` is imported on
demand.
"""
from repro_torch.serve.events import (  # noqa: F401
    ARRIVAL_PRESETS,
    ArrivalProcess,
    EventState,
    PacedCarry,
    ServePacing,
    expand_events,
    get_arrival,
    list_arrivals,
)
from repro_torch.serve.serving import ServeLoop, component_mean_params, decode_greedy  # noqa: F401

__all__ = [
    "ARRIVAL_PRESETS",
    "ArrivalProcess",
    "EventState",
    "PacedCarry",
    "ServePacing",
    "expand_events",
    "get_arrival",
    "list_arrivals",
    "ServeLoop",
    "component_mean_params",
    "decode_greedy",
]
