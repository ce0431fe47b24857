"""AD-GDA core (PyTorch port of ``repro.core``): topologies, schedules and
their permute plans, compressors, CHOCO gossip, the union wire with its
NeighborCache and wire faults, the neighbour-exchange backend on
``torch.distributed`` ranks, the DRO duals, the composable trainer and the
paper's baselines."""
from repro_torch.core.adgda import ADGDAConfig, adgda_trainer
from repro_torch.core.baselines import (
    DRDSGDConfig,
    DRFAConfig,
    choco_sgd,
    drdsgd_trainer,
    drfa_trainer,
)
from repro_torch.core.compression import (
    BlockTopK,
    Compressor,
    Identity,
    RandomQuantization,
    TopK,
    make_compressor,
)
from repro_torch.core.exchange import (
    choco_round_cached_local,
    choco_round_cached_local_lanes,
    choco_round_ppermute,
    choco_round_ppermute_lanes,
    mix_stacked_faulted_local,
    mix_stacked_ppermute,
    node_mesh_info,
    server_average_ppermute,
)
from repro_torch.core.gossip import CHOCOState, choco_init, choco_round
from repro_torch.core.topology import (
    PermutePlan,
    Topology,
    TopologySchedule,
    compile_permute_plan,
    compile_schedule_plans,
    make_topology,
    make_topology_schedule,
)
from repro_torch.core.trainer import DecentralizedTrainer, TrainerState
from repro_torch.core.wire import (
    DENSE,
    HAT_DELTA,
    PAYLOAD,
    UnionWirePlan,
    WireFormat,
    compile_union_wire,
    init_neighbor_cache,
)

__all__ = [
    "ADGDAConfig",
    "DENSE",
    "HAT_DELTA",
    "PAYLOAD",
    "WireFormat",
    "DRDSGDConfig",
    "DRFAConfig",
    "BlockTopK",
    "CHOCOState",
    "Compressor",
    "DecentralizedTrainer",
    "Identity",
    "PermutePlan",
    "RandomQuantization",
    "TopK",
    "Topology",
    "TopologySchedule",
    "TrainerState",
    "UnionWirePlan",
    "adgda_trainer",
    "choco_init",
    "choco_round",
    "choco_round_cached_local",
    "choco_round_cached_local_lanes",
    "choco_round_ppermute",
    "choco_round_ppermute_lanes",
    "choco_sgd",
    "compile_permute_plan",
    "compile_schedule_plans",
    "compile_union_wire",
    "drdsgd_trainer",
    "drfa_trainer",
    "init_neighbor_cache",
    "make_compressor",
    "make_topology",
    "make_topology_schedule",
    "mix_stacked_faulted_local",
    "mix_stacked_ppermute",
    "node_mesh_info",
    "server_average_ppermute",
]
