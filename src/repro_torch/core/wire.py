"""Wire-format tags (the part of ``repro.core.wire`` the trainer reads):
:class:`Lane`, :class:`WireFormat` and the single-lane formats ``PAYLOAD``
/ ``DENSE`` / ``HAT_DELTA``.  They label a consensus's per-edge message and
key its per-lane bit accounting; the bits themselves come from
``gossip.payload_bits``.  The union wire and the NeighborCache are not
ported (see ROADMAP.md)."""
from __future__ import annotations

import dataclasses

__all__ = ["Lane", "WireFormat", "PAYLOAD", "DENSE", "HAT_DELTA"]


@dataclasses.dataclass(frozen=True)
class Lane:
    """One state variable's slot in a per-edge message: ``kind`` is
    ``"payload"`` (the compressor's encoding), ``"dense"`` (the raw f32
    tensor) or ``"hat-delta"`` (a compressed increment to the receiver's
    mirror); ``name`` says which variable rides it (``"model"``,
    ``"tracker"``, ...)."""

    kind: str
    name: str = "model"

    def __str__(self) -> str:
        return self.kind if self.name == "model" else f"{self.name}:{self.kind}"


def _as_lanes(lanes) -> tuple:
    if isinstance(lanes, str):
        return (Lane(lanes),)
    if isinstance(lanes, Lane):
        return (lanes,)
    return tuple(Lane(x) if isinstance(x, str) else x for x in lanes)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """An ordered tuple of :class:`Lane` descriptors, one per variable on
    the wire; a single-lane format answers ``kind``."""

    lanes: tuple[Lane, ...]

    def __post_init__(self):
        object.__setattr__(self, "lanes", _as_lanes(self.lanes))
        if not self.lanes:
            raise ValueError("WireFormat needs at least one lane")

    @property
    def kind(self) -> str:
        if len(self.lanes) != 1:
            raise ValueError(f"multi-lane format {self} has no single kind; iterate lanes")
        return self.lanes[0].kind

    def __len__(self) -> int:
        return len(self.lanes)

    def __iter__(self):
        return iter(self.lanes)

    def __getitem__(self, i) -> Lane:
        return self.lanes[i]

    def __str__(self) -> str:
        return "+".join(str(lane) for lane in self.lanes)


PAYLOAD = WireFormat("payload")
DENSE = WireFormat("dense")
HAT_DELTA = WireFormat("hat-delta")
