"""AD-GDA core (PyTorch port of ``repro.core``): topologies, compressors,
CHOCO gossip, the DRO dual, and the composable trainer's main path."""
from repro_torch.core.adgda import ADGDAConfig, adgda_trainer
from repro_torch.core.baselines import choco_sgd
from repro_torch.core.compression import (
    BlockTopK,
    Compressor,
    Identity,
    RandomQuantization,
    TopK,
    make_compressor,
)
from repro_torch.core.gossip import CHOCOState, choco_init, choco_round
from repro_torch.core.topology import Topology, make_topology
from repro_torch.core.trainer import DecentralizedTrainer, TrainerState

__all__ = [
    "ADGDAConfig",
    "BlockTopK",
    "CHOCOState",
    "Compressor",
    "DecentralizedTrainer",
    "Identity",
    "RandomQuantization",
    "TopK",
    "Topology",
    "TrainerState",
    "adgda_trainer",
    "choco_init",
    "choco_round",
    "choco_sgd",
    "make_compressor",
    "make_topology",
]
