"""Roofline terms of a dry-run pair on the NVIDIA H100 (port of
``repro.launch.roofline``):

    compute    = flops_per_device / peak bf16 FLOP/s
    memory     = bytes_per_device / HBM bandwidth
    collective = collective_bytes_per_device / link bandwidth

The per-device flops, bytes and collective bytes are ``launch/op_cost.py``'s
count of the port's eager program; the memory per device is the dry run's
(``launch/dryrun.py``).

Hardware constants, NVIDIA H100 80GB HBM3 at its 700.00 W power limit (the
name and limit ``nvidia-smi`` gives), from NVIDIA's data sheet (SXM, dense):
989.4 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.  Links: NVLink 4
moves 450 GB/s each way per GPU inside an 8-GPU node; traffic that leaves
the node goes over the GPU's own 400 Gb/s network port, 50 GB/s.  The
production meshes (16 x 16, 2 x 16 x 16) put 16 GPUs on the ``model`` axis,
two 8-GPU NVLink domains, and every ``data`` step on another node, so each
of their collectives leaves a node: the collective term of a mesh of more
than 8 devices uses 50 GB/s (the link model), of at most 8 NVLink's rate.
A one-card machine measures neither link.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW", "roofline_terms", "RooflineReport", "model_flops_for", "link_bandwidth"]

PEAK_FLOPS = 989.4e12  # bf16 dense, tensor cores (NVIDIA H100 80GB HBM3, 700.00 W)
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 450e9  # bytes/s each way per GPU, NVLink 4 inside an 8-GPU node
NODE_LINK_BW = 50e9  # bytes/s per GPU leaving the node: one 400 Gb/s port
NVLINK_DOMAIN = 8  # GPUs per NVLink node

HW = {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
      "node_link_bw": NODE_LINK_BW}


def link_bandwidth(chips: int) -> float:
    """The link a mesh of ``chips`` devices' collectives run at (see the
    module docstring)."""
    return NVLINK_BW if chips <= NVLINK_DOMAIN else NODE_LINK_BW


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops: float  # per device
    bytes_accessed: float  # per device
    coll_bytes: dict[str, int]  # per device, by kind
    model_flops: float  # 6*N(active)*tokens, global
    chips: int
    mem_per_device: dict | None = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(self.coll_bytes.values()) / link_bandwidth(self.chips)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        total = self.flops * self.chips
        return (self.model_flops / total) if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.flops,
            "hlo_bytes_per_dev": self.bytes_accessed,
            "coll_bytes": dict(self.coll_bytes),
            "useful_flops_frac": self.useful_flops_frac,
            "mem_per_device": self.mem_per_device,
        }


def roofline_terms(cost, mem: dict | None, *, arch: str, shape: str, mesh_name: str,
                   chips: int, model_flops: float) -> RooflineReport:
    """Per-device roofline terms from an ``op_cost.Cost`` and the dry run's
    memory per device (the reference's keys: argument / output / temp /
    generated-code bytes, plus the peak)."""
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        flops=float(cost.flops),
        bytes_accessed=float(cost.bytes),
        coll_bytes={k: int(v) for k, v in cost.coll.items()},
        model_flops=model_flops,
        chips=chips,
        mem_per_device=mem,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 * N_active * tokens processed (2 * for a forward)."""
    from repro_torch.models.transformer import active_param_count

    n_active = active_param_count(cfg)
    if shape.step == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.step == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len  # forward only
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/seq, fwd only
