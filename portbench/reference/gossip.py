"""The plain reference of one AD-GDA round's wire (paper Algorithm 1):
CHOCO-GOSSIP with a compressor, the dual's projected ascent and its gossip,
the consensus error and the bits a round puts on the wire.  Plain
``torch`` in float32 over state stored in the configuration's type; it
imports nothing of the port.

The chunking of large leaves (one quantization norm per node and chunk) is
the one the paper's reference implementation scans with, copied here as
:func:`scan_plan`; the uniform noise of each encode is drawn, chunk after
chunk in leaf order, from a ``torch.Generator`` seeded with the run's
gossip seed, in the padded ``[m, rows, 128]`` shape the packed wire uses,
so the reference and the program quantize with the same draws.
"""
from __future__ import annotations

import math

import torch

LANES = 128
BLOCK_SCAN_ELEMS = 1 << 24


def scan_plan(shape, block_scan_elems: int = BLOCK_SCAN_ELEMS):
    """(axis, chunks, rows) for a stacked leaf [m, ...] gossiped in chunks,
    or None: a stacked-layer axis 1 of at most 128 is split into chunks of
    whole layers, else the last axis."""
    inner = math.prod(shape[1:]) if len(shape) > 1 else 1
    if len(shape) <= 1 or inner <= block_scan_elems:
        return None
    nb = shape[1] if len(shape) > 2 else 1
    if 1 < nb <= 128:
        per_row = inner // nb
        target = max(1, block_scan_elems // max(per_row, 1))
        rows = next(r for r in range(min(target, nb), 0, -1) if nb % r == 0)
        chunks = nb // rows
        return (1, chunks, rows) if 1 < chunks <= 512 else None
    last = shape[-1]
    want = max(2, -(-inner // block_scan_elems))
    for c in range(min(want, last), min(513, last + 1)):
        if last % c == 0:
            return (len(shape) - 1, c, last // c)
    return None


def chunk_views(x: torch.Tensor, plan) -> list[torch.Tensor]:
    if plan is None:
        return [x]
    axis, chunks, rows = plan
    if axis == 1:
        return [x.narrow(1, c * rows, rows) for c in range(chunks)]
    split = x.reshape(x.shape[:-1] + (chunks, rows))
    return [split.select(-2, c) for c in range(chunks)]


def encode_dim(shapes) -> int:
    """The largest per-node encode of a round (the size gamma is set from)."""
    best = 1
    for shape in shapes:
        inner = math.prod(shape[1:]) if len(shape) > 1 else 1
        plan = scan_plan(shape)
        best = max(best, inner if plan is None else inner // plan[1])
    return best


class Quantize:
    """Stochastic b-bit quantization with one norm per node and encode:
    level = clamp(floor(|r| 2^b / ||r|| + xi), 0, 2^b - 1), value = sign(r)
    level ||r|| / (2^b tau(d)), tau(d) = 1 + min(d / 4^b, sqrt(d) / 2^b)."""

    def __init__(self, bits: int):
        self.bits = bits

    def tau(self, d: int) -> float:
        lvl = float(1 << self.bits)
        return 1.0 + min(d / lvl**2, math.sqrt(d) / lvl)

    def delta(self, d: int) -> float:
        return 1.0 / self.tau(d)

    def noise_shape(self, m: int, d: int):
        unit = (8 // self.bits) * 8 * LANES
        return (m, -(-d // unit) * unit // LANES, LANES)

    def __call__(self, r: torch.Tensor, xi: torch.Tensor):
        """(the decoded encode of r [m, d], the bits each node's encode
        holds: every entry's level and sign, and its one float32 norm)."""
        m, d = r.shape
        lvl = float(1 << self.bits)
        norm = torch.linalg.vector_norm(r, dim=1, keepdim=True)
        u = xi.reshape(m, -1)[:, :d]
        q = torch.clamp(torch.floor(r.abs() * (lvl / torch.clamp(norm, min=1e-30)) + u),
                        0, lvl - 1)
        mag = q * (norm / (lvl * self.tau(d)))
        bits = torch.full((m,), (self.bits + 1) * d + 32, dtype=torch.int64, device=r.device)
        return torch.where(r < 0, -mag, mag), bits


class BlockTopK:
    """Per node, each block of ``block`` elements (zero-padded) keeps its k =
    round(fraction * block) largest magnitudes, the threshold found by 20
    rounds of bisection over [0, max |x|] (the system's definition of the
    operator): every entry at or above the final upper end is kept, so a
    tie at the k-th place is dropped whole and a largest magnitude shared by
    more than k entries is kept whole.  Values and in-block indices go on
    the wire."""

    ITERS = 20

    def __init__(self, fraction: float, block: int):
        self.fraction, self.block = fraction, block

    def delta(self, d: int) -> float:
        return self.fraction

    def noise_shape(self, m: int, d: int):
        return None

    def keep(self, r: torch.Tensor) -> torch.Tensor:
        """The entries of r [m, d] the encode keeps (bool)."""
        m, d = r.shape
        pad = (-d) % self.block
        mag = torch.nn.functional.pad(r, (0, pad)).reshape(m, -1, self.block).abs()
        k = max(1, round(self.fraction * self.block))
        hi = mag.amax(-1, keepdim=True)
        lo = torch.zeros_like(hi)
        for _ in range(self.ITERS):
            mid = 0.5 * (lo + hi)
            over = (mag >= mid).sum(-1, keepdim=True) > k
            lo, hi = torch.where(over, mid, lo), torch.where(over, hi, mid)
        return (mag >= hi).reshape(m, -1)[:, :d]

    def __call__(self, r: torch.Tensor, xi=None):
        """(the kept entries of r [m, d], the bits each node's encode holds:
        a float32 value and an in-block index for every entry it keeps)."""
        keep = self.keep(r)
        return r * keep, keep.sum(1) * (32 + int(math.log2(self.block)))


def make_compressor(spec: dict):
    """A workload's ``compressor``: ``{"spec": "kq4b"}`` (the kernel
    quantizer at 4 bits) or ``{"kind": "block_topk", "fraction", "block"}``."""
    if "spec" in spec:
        s = spec["spec"]
        if s.startswith("kq") and s.endswith("b"):
            return Quantize(int(s[2:-1]))
        raise ValueError(f"no reference for compressor spec {s!r}")
    if spec.get("kind") == "block_topk":
        return BlockTopK(spec["fraction"], spec["block"])
    raise ValueError(f"no reference for compressor {spec!r}")


def ring_shifts(m: int):
    """The ring's circulant weights: self and both neighbours, 1/3 each."""
    if m < 3:
        return tuple((k, 1.0 / m) for k in range(m))
    return ((0, 1.0 / 3.0), (1, 1.0 / 3.0), (-1, 1.0 / 3.0))


def mix(x: torch.Tensor, shifts) -> torch.Tensor:
    """sum_j w_ij x_j along the node axis: node i hears node i - shift."""
    out = torch.zeros_like(x)
    for shift, w in shifts:
        out = out + w * torch.roll(x, shift, 0)
    return out


def gamma(comp, shapes) -> float:
    """The consensus step size: half the compressor's delta at the round's
    largest encode."""
    return 0.5 * max(comp.delta(encode_dim(shapes)), 1e-3)


@torch.no_grad()
def choco_round(theta, hat, s, comp, shifts, gam: float, gen, *, skip_mix: bool = False):
    """One CHOCO round, in place over stacked leaves [m, ...]:
    theta <- theta + gamma (s - hat); q = Q(theta - hat); hat <- hat + q;
    s <- s + sum_j w_ij q_j; float32 arithmetic, stored in each leaf's type.
    Returns the bits of every node's encodes [m] (int64), as encoded: one
    norm an encode (a chunk of a large leaf is its own encode), a block's
    every tied entry.  ``skip_mix`` leaves the neighbours' q out of s (a
    fault: nothing is sent, and no bits are counted)."""
    sent = torch.zeros(theta[0].shape[0], dtype=torch.int64, device=theta[0].device)
    for th, ht, sl in zip(theta, hat, s):
        plan = scan_plan(tuple(th.shape))
        for tc, hc, sc in zip(*(chunk_views(x, plan) for x in (th, ht, sl))):
            m = tc.shape[0]
            t32, h32, s32 = (x.reshape(m, -1).float() for x in (tc, hc, sc))
            shape = comp.noise_shape(m, t32.shape[1])
            xi = (None if shape is None else
                  torch.rand(shape, generator=gen, dtype=torch.float32, device=th.device))
            t_new = (t32 + gam * (s32 - h32)).to(th.dtype)
            q, bits = comp(t_new.float() - h32, xi)
            tc.copy_(t_new.reshape(tc.shape))
            hc.copy_((h32 + q).to(ht.dtype).reshape(hc.shape))
            if not skip_mix:
                sc.copy_((s32 + mix(q, shifts)).to(sl.dtype).reshape(sc.shape))
                sent += bits
    return sent


def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row onto the probability simplex."""
    u = torch.sort(v, dim=-1, descending=True).values
    css = torch.cumsum(u, -1) - 1.0
    ind = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    rho = ((u - css / ind) > 0).float().mul(ind).amax(-1, keepdim=True)
    tau = torch.gather(css, -1, rho.long() - 1) / rho
    return torch.clamp(v - tau, min=0.0)


def dual_step(lam, losses, prior, alpha: float, eta: float, shifts) -> torch.Tensor:
    """AD-GDA's dual: node i ascends its own copy of lambda along
    f_i e_i + alpha grad r(lambda) (r = -chi^2(lambda || prior)), projects it
    onto the simplex, and the copies are gossiped uncompressed."""
    m = lam.shape[0]
    reg_grad = -2.0 * (lam - prior) / prior
    grads = torch.diag(losses) + alpha * reg_grad
    return mix(project_simplex(lam + eta * grads), shifts)


@torch.no_grad()
def consensus_error(theta) -> float:
    """sum_i ||theta_i - mean||^2 over every leaf, float32."""
    total = 0.0
    for th in theta:
        x = th.reshape(th.shape[0], -1).float()
        total += float(((x - x.mean(0, keepdim=True)) ** 2).sum())
    return total


def round_bits(sent: torch.Tensor, m: int, degree: int) -> float:
    """The busiest node's bits a round: its encodes (``choco_round``'s
    count) to each of its ``degree`` neighbours, plus the dual's m float32
    to each, counted exactly."""
    return float(int(sent.max()) * degree + 32 * m * degree)
