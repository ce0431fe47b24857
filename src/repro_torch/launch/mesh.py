"""Process meshes for the ``ppermute`` gossip backend (port of
``repro.launch.mesh.make_node_mesh``).

The reference shards the node axis over a JAX device mesh and exchanges
with ``lax.ppermute``; here each ``torch.distributed`` rank holds one
contiguous block of ``num_nodes / R`` nodes and exchanges over
point-to-point sends.  A launcher (``python -m torch.distributed.run``)
sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``; without them the mesh has
one rank, the reference's degenerate one-device mesh, on which every
exchange is a local roll or gather.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen3-1.7b --nodes 4 \\
        --compressor kq4b --gossip-backend ppermute

The process group is gloo (:data:`BACKEND`): a card's tensors are staged
through page-locked host buffers.  NCCL runs one rank per card; ranks that
share a card (more ranks than cards) need gloo.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["BACKEND", "NodeMesh", "make_node_mesh"]

#: the process group's backend (no automatic switch)
BACKEND = "gloo"


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """One rank's place on the node mesh: ``rank`` of ``size`` processes,
    the rank's ``device``, and the process group (None: the default
    group, or no group on a one-rank mesh)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    def block(self, num_nodes: int) -> int:
        """Nodes per rank (raises when ``num_nodes % size != 0``)."""
        from repro_torch.core.exchange import node_mesh_info

        return node_mesh_info(self, "data", num_nodes)[2]

    def rows(self, num_nodes: int) -> slice:
        """This rank's contiguous rows of the node axis."""
        b = self.block(num_nodes)
        return slice(self.rank * b, (self.rank + 1) * b)


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def make_node_mesh(num_nodes: int, *, device="cuda", init_method: str | None = None,
                   rank: int | None = None, world_size: int | None = None,
                   log: bool = True) -> NodeMesh:
    """The node mesh of this process.

    ``rank`` / ``world_size`` default to the launcher's ``RANK`` /
    ``WORLD_SIZE`` (a one-rank mesh when unset).  A multi-rank mesh joins
    the gloo process group at ``init_method`` (default ``env://``, the
    launcher's store; tests pass ``file://``) unless one is already up.
    On the card the rank's device is ``cuda:{LOCAL_RANK % device_count}``:
    ranks share a card when there are more ranks than cards.  Raises when
    ``num_nodes`` is not a multiple of the rank count, as the reference's
    ``node_mesh_info`` does."""
    dev = resolve_device(device)
    rank = _env_int("RANK", 0) if rank is None else rank
    size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", _env_int("LOCAL_RANK", rank) % count)
        torch.cuda.set_device(dev)
    mesh = NodeMesh(rank=rank, size=size, device=dev)
    block = mesh.block(num_nodes)
    if size > 1 and not dist.is_initialized():
        dist.init_process_group(BACKEND, init_method=init_method or "env://", rank=rank,
                                world_size=size)
    if log:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        kind = ("one-rank mesh (the reference's degenerate one-device mesh: exchanges are "
                "local rolls)" if size == 1 else f"{BACKEND} process group")
        print(f"mesh: rank {rank} of {size}, nodes [{rank * block}, {(rank + 1) * block}) "
              f"of {num_nodes}, device {dev} ({cards} cards visible), {kind}", flush=True)
    return mesh
