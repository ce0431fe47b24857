from repro_torch.data.synthetic import (
    HeterogeneousDataset,
    node_token_stream,
    rotated_minority_classification,
)

__all__ = ["HeterogeneousDataset", "node_token_stream", "rotated_minority_classification"]
