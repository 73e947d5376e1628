"""PaME core: topology, PME, gossip contraction and mixers, compression,
the compressed exchange, engine, Algorithm 1, the five baselines, the
registry with its batched seed and config lanes, and dynamic networks —
i.i.d. scenarios, Markov dynamics with bounded staleness, message-level
faults (port of `repro.core`)."""
from repro_torch.core import (
    algorithms,
    baselines,
    compression,
    engine,
    faults,
    gossip,
    lanes,
    mixing,
    pme,
    scenarios,
    temporal,
)
from repro_torch.core.algorithms import (
    Algorithm,
    BatchedAlgorithm,
    BoundAlgorithm,
    get_algorithm,
    lane_finals,
    list_algorithms,
    register,
)
from repro_torch.core.baselines import (
    BeerState,
    ChocoState,
    DFedSAMState,
    DPSGDState,
    NidsState,
    beer_init,
    beer_step,
    choco_init,
    choco_step,
    dfedsam_init,
    dfedsam_step,
    dpsgd_init,
    dpsgd_step,
    nids_init,
    nids_step,
    run_algorithm,
    stack_params,
)
from repro_torch.core.compression import Compressor, identity, one_bit, qsgd, rand_k, top_k
from repro_torch.core.engine import run_batched
from repro_torch.core.gossip import compressed_pme_average_pytree, systematic_offsets
from repro_torch.core.mixing import (
    Mixer,
    PaddedMixing,
    as_mixer,
    gather_terms,
    make_mixer,
    mix_padded,
)
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
    message_bits,
    naive_average,
    pme_average,
    pme_average_pytree,
    pme_average_pytree_padded,
    sample_coordinate_masks,
    sample_neighbor_selection,
    sample_neighbor_selection_padded,
)
from repro_torch.core.scenarios import (
    Scenario,
    get_scenario,
    list_scenarios,
    make_scenario_arrays,
    realize,
)
from repro_torch.core.temporal import (
    TemporalScenario,
    get_temporal_scenario,
    list_temporal_scenarios,
)
from repro_torch.core.topology import Topology, build_topology

__all__ = [
    "algorithms", "baselines", "compression", "engine", "faults", "gossip", "lanes",
    "mixing", "pme", "scenarios", "temporal",
    "Algorithm", "BatchedAlgorithm", "BoundAlgorithm", "get_algorithm", "lane_finals",
    "list_algorithms", "register", "run_batched", "gather_terms", "message_bits",
    "naive_average",
    "PaMEConfig", "PaMEState", "TopologyArrays", "make_pame_runner",
    "make_topology_arrays", "pame_init", "pame_step", "run_pame",
    "pme_average", "pme_average_pytree", "pme_average_pytree_padded",
    "sample_coordinate_masks", "sample_neighbor_selection",
    "sample_neighbor_selection_padded", "Topology", "build_topology",
    "Mixer", "PaddedMixing", "make_mixer", "as_mixer", "mix_padded",
    "Compressor", "identity", "rand_k", "top_k", "qsgd", "one_bit",
    "compressed_pme_average_pytree", "systematic_offsets",
    "DPSGDState", "dpsgd_init", "dpsgd_step",
    "DFedSAMState", "dfedsam_init", "dfedsam_step",
    "ChocoState", "choco_init", "choco_step",
    "BeerState", "beer_init", "beer_step",
    "NidsState", "nids_init", "nids_step",
    "stack_params", "run_algorithm",
    "Scenario", "get_scenario", "list_scenarios", "make_scenario_arrays", "realize",
    "TemporalScenario", "get_temporal_scenario", "list_temporal_scenarios",
]
