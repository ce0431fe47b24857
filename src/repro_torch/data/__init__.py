from repro_torch.data.synthetic import (
    HeterogeneousDataset,
    class_shard_classification,
    contrast_shift_classification,
    instrument_shift_classification,
    node_token_stream,
    rotated_minority_classification,
)

__all__ = [
    "HeterogeneousDataset",
    "class_shard_classification",
    "contrast_shift_classification",
    "instrument_shift_classification",
    "node_token_stream",
    "rotated_minority_classification",
]
