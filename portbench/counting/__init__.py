"""The yardstick's arithmetic: the chip's published peaks, a training
round's model FLOPs, and the bytes the gossip kernels must move, each from
shapes alone."""
