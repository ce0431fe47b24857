"""AD-GDA core (PyTorch port of ``repro.core``): topologies and schedules,
compressors, CHOCO gossip, the DRO duals, the composable trainer and the
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
from repro_torch.core.gossip import CHOCOState, choco_init, choco_round
from repro_torch.core.topology import (
    Topology,
    TopologySchedule,
    make_topology,
    make_topology_schedule,
)
from repro_torch.core.trainer import DecentralizedTrainer, TrainerState

__all__ = [
    "ADGDAConfig",
    "DRDSGDConfig",
    "DRFAConfig",
    "BlockTopK",
    "CHOCOState",
    "Compressor",
    "DecentralizedTrainer",
    "Identity",
    "RandomQuantization",
    "TopK",
    "Topology",
    "TopologySchedule",
    "TrainerState",
    "adgda_trainer",
    "choco_init",
    "choco_round",
    "choco_sgd",
    "drdsgd_trainer",
    "drfa_trainer",
    "make_compressor",
    "make_topology",
    "make_topology_schedule",
]
