"""PaME core: topology, PME, gossip contraction, engine, Algorithm 1 and
the registry (port of `repro.core`)."""
from repro_torch.core import algorithms, engine, mixing, pme
from repro_torch.core.pame import (
    PaMEConfig,
    PaMEState,
    TopologyArrays,
    make_pame_runner,
    make_topology_arrays,
    pame_init,
    pame_step,
    run_pame,
)
from repro_torch.core.pme import (
    pme_average,
    pme_average_pytree,
    pme_average_pytree_padded,
    sample_coordinate_masks,
    sample_neighbor_selection,
    sample_neighbor_selection_padded,
)
from repro_torch.core.topology import Topology, build_topology

__all__ = [
    "algorithms", "engine", "mixing", "pme",
    "PaMEConfig", "PaMEState", "TopologyArrays", "make_pame_runner",
    "make_topology_arrays", "pame_init", "pame_step", "run_pame",
    "pme_average", "pme_average_pytree", "pme_average_pytree_padded",
    "sample_coordinate_masks", "sample_neighbor_selection",
    "sample_neighbor_selection_padded", "Topology", "build_topology",
]
