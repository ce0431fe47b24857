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

The production meshes of ``repro.launch.mesh`` (the dry run's,
``launch/dryrun.py``): ``(data=16, model=16)`` = 256 devices, and with a
leading ``pod`` axis of 2, 512.  Here they are a ``DeviceMesh`` over a
world of fake ranks in one process (``torch.distributed``'s ``"fake"``
backend, :func:`fake_world`), seen from rank 0: the per-device program, as
XLA's post-SPMD module is.  Collectives on it move nothing.  The world is
global state: whoever asks for it sets it up and tears it down
(:func:`fake_world` is a context manager), so it never meets the trainer's
gloo worlds.  Functions, not module constants, so importing starts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = [
    "BACKEND",
    "NodeMesh",
    "make_node_mesh",
    "fake_device_type",
    "fake_world",
    "make_production_mesh",
    "make_cpu_mesh",
    "node_axes",
    "num_nodes",
]

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


# ------------------------------------------------------- production meshes
def fake_device_type() -> str:
    """The device the dry run's fake tensors and meshes name: ``"cuda"``
    where a card is visible, else ``"cpu"`` (without one, even a fake CUDA
    tensor cannot be indexed).  Nothing runs on it either way."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(ranks: int):
    """A world of ``ranks`` fake processes, this one rank 0, for the extent
    of the ``with``; raises if a process group is already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple, axes: tuple, device_type: str | None = None):
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {need} ranks, the world "
                           f"has {have}: run it inside launch.mesh.fake_world({need}) (the dry "
                           f"run does) or on real hardware")
    return init_device_mesh(device_type or fake_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"), on the current (fake) world; ``device_type`` defaults to
    :func:`fake_device_type`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def node_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the AD-GDA node dimension shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def num_nodes(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return int(sizes.get("pod", 1) * sizes["data"])


def make_cpu_mesh(data: int = 1, model: int = 1):
    """A small (data, model) mesh on the current world (``fake_world(data *
    model)``): the dry run's one-device mesh, a TP-2 mesh in tests."""
    return _mesh((data, model), ("data", "model"))
