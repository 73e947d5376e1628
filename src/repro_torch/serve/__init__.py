"""Serving (port of `repro.serve`): :class:`serving.ServeLoop`, batched
greedy decode against each node's current parameters with per-node service
cost, and the consensus-serving parameter mean.  The event clock
(`repro.serve.events`) and elastic membership (`repro.serve.membership`)
come in later slices."""
from repro_torch.serve.serving import ServeLoop, component_mean_params, decode_greedy

__all__ = ["ServeLoop", "component_mean_params", "decode_greedy"]
