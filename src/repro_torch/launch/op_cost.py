"""Per-device cost of an eager PyTorch program: the counterpart of
``repro/launch/hlo_cost.py``'s trip-count-aware HLO analysis.

``hlo_cost.py`` reads XLA's optimized, post-SPMD HLO; here the program is
the port's own eager code, run under :class:`OpCost` (a
``TorchDispatchMode``), usually over fake tensors (``FakeTensorMode``) and
DTensors on a fake-rank mesh (``launch/mesh.py``), so nothing is computed
or allocated.  In eager PyTorch every dispatched op is a kernel, so each
op's boundary is device-memory traffic, as a fusion's boundary is in XLA:

  * flops: 2·M·N·K for every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
    ``matmul`` (batch included), plus one flop per output element for the
    elementwise and reduction ops of the reference's ``_ARITH`` set
    (:data:`ARITH`: add, multiply, exp, compare, select, reduce, ...);
  * bytes: inputs plus outputs of every op that is not a view, an alias or
    a factory (the reference's ``_SKIP_BYTES``); a write into part of a
    tensor (``copy_``, ``index_put_``, ``scatter``) counts the part twice,
    as the reference counts a dynamic-update-slice;
  * coll: operand bytes by the reference's five kinds, from the c10d
    functional collectives that DTensor issues (``all_reduce``,
    ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single``) and the point-to-point ops (a send or a receive
    is a ``collective-permute``).

All figures are per device: DTensor ops return ``NotImplemented`` here and
are counted as the local ops and collectives they become, and the ops
DTensor runs on global shapes to propagate its metadata are not counted.
The reference multiplies ``while`` bodies by their trip count; the eager
program runs its loops, so the count is exact without that.

With ``track_memory`` the mode also follows the program's live storages
(each op's new outputs, freed when their last tensor goes): ``peak_bytes``
is the most held at once, arguments included (:meth:`OpCost.hold`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Cost", "OpCost", "ARITH", "COLLECTIVES"]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)

#: aten ops counted as one flop per output element (the reference's _ARITH:
#: its HLO opcodes, under their aten names)
ARITH = frozenset({
    "add", "sub", "rsub", "mul", "div", "pow", "exp", "exp2", "log", "log2", "tanh", "rsqrt",
    "sqrt", "neg", "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "eq", "ne", "lt",
    "le", "gt", "ge", "where", "masked_fill", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "sin", "cos", "floor", "ceil",
    "abs", "sign", "atan2", "remainder", "fmod", "sum", "mean", "amax", "amin", "max", "min",
    "prod", "cumsum", "expm1", "log1p", "sigmoid", "erf", "reciprocal", "_softmax",
    "_log_softmax", "logsumexp", "silu", "gelu", "softplus", "addcmul", "addcdiv", "lerp",
})

_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul"})

#: ops that move no bytes: views and aliases (``OpOverload.is_view`` covers
#: the rest), factories, metadata
_SKIP_BYTES = frozenset({
    "_unsafe_view", "alias", "detach", "lift_fresh", "lift_fresh_copy", "empty", "empty_like",
    "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "arange",
    "scalar_tensor", "rand", "randn", "randint", "normal", "_local_scalar_dense", "wait_tensor",
    "device", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_",
})

#: collective ops by kind (the c10d functional ops and the process group's
#: own dispatcher ops)
_COLL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict | None = None

    def __post_init__(self):
        if self.coll is None:
            self.coll = {k: 0.0 for k in COLLECTIVES}

    def __iadd__(self, other: "Cost"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k in COLLECTIVES:
            self.coll[k] += other.coll[k]
        return self

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())

    def wire_bytes(self, num_partitions: int) -> float:
        """Bytes actually transmitted per device under ring algorithms (the
        reference's estimate): an all-gather of a shard S relays (n-1)
        shards, an all-reduce ~2 S (n-1)/n; a permute's operand is its wire."""
        n = max(int(num_partitions), 1)
        c = self.coll
        return (c["collective-permute"] + c["all-gather"] * (n - 1)
                + c["reduce-scatter"] * (n - 1) / n + c["all-reduce"] * 2.0 * (n - 1) / n
                + c["all-to-all"] * (n - 1) / n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    """The tensors of a tree of lists, tuples, dicts and dataclasses (a
    trainer state)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _matmul_flops(name: str, args, out) -> float:
    """2 x (output elements) x (contraction length)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _dtensor_host_work():
    """DTensor's own work on the host: the sharding propagation (it runs
    ops on global shapes to derive metadata, and tensor arithmetic on the
    mesh's coordinates) and the redistribution plans.  None of it is the
    per-device program; (class, name) pairs, by the names the installed
    torch has."""
    from torch.distributed.tensor import _redistribute, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    found = [(ShardingPropagator, n) for n in ("propagate_op_sharding_non_cached",
                                               "_propagate_tensor_meta_non_cached")
             if hasattr(ShardingPropagator, n)]
    found += [(_redistribute, n) for n in ("_gen_transform_infos_non_cached",)
              if hasattr(_redistribute, n)]
    strided = getattr(placement_types, "_StridedShard", None)  # its offsets are tensor maths
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        found.append((strided, "local_shard_size_and_offset"))
    return found


class _Forwarding:
    """``call`` in place of a callable object whose other attributes (a
    cache's) stay reachable."""

    def __init__(self, inner, call):
        self._inner, self._call = inner, call

    def __call__(self, *a, **kw):
        return self._call(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class OpCost(TorchDispatchMode):
    """Count the per-device cost of the ops run under it (see the module
    docstring); ``cost`` holds the totals.  Enter it inside the
    ``FakeTensorMode``, so that it sees each op first."""

    def __init__(self, *, track_memory: bool = False):
        super().__init__()
        self.cost = Cost()
        self.matmul_flops = 0.0  # the products' share of cost.flops
        self.ops = 0
        self.track_memory = track_memory
        self._shadow = 0
        self._live: dict[int, tuple[StorageWeakRef, int]] = {}
        self._held: set[int] = set()
        self.held_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._patched: list = []

    # ---------------------------------------------------------- memory
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local shard)
        as live arguments for the whole run; returns their bytes."""
        added = 0
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            key = self._key(t)
            if key not in self._held:
                self._held.add(key)
                added += t.untyped_storage().nbytes()
        self.held_bytes += added
        self.peak_bytes = max(self.peak_bytes, self.held_bytes + self.live_bytes)
        return added

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]

    def _track(self, out) -> None:
        self._sweep()
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._live:
                continue
            self._live[key] = (StorageWeakRef(st), st.nbytes())
            self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.held_bytes + self.live_bytes)

    def live_new(self, tree) -> int:
        """Bytes of ``tree``'s storages that the run made (not arguments)."""
        seen, total = set(), 0
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            key = self._key(t)
            if key not in self._held and key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
        return total

    # -------------------------------------------------------- dispatch
    def _shadowed(self, real):
        """``real`` run uncounted, and on real host tensors: a fake mode
        would turn the coordinates' arithmetic into fake tensors."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def shadowed(*a, **kw):
            self._shadow += 1
            try:
                with unset_fake_temporarily():
                    return real(*a, **kw)
            finally:
                self._shadow -= 1

        return shadowed

    def __enter__(self):
        import inspect

        from torch.distributed.tensor import DTensor

        for owner, name in _dtensor_host_work():
            raw = inspect.getattr_static(owner, name)
            kind = type(raw) if isinstance(raw, (staticmethod, classmethod)) else None
            shadowed = self._shadowed(raw.__func__ if kind else raw)
            setattr(owner, name, kind(shadowed) if kind else shadowed)
            self._patched.append((owner, name, raw))
        # the dispatcher's propagator caches the bound propagation at its
        # construction: its cached entry point, too
        prop = DTensor._op_dispatcher.sharding_propagator
        cached = vars(prop).get("propagate_op_sharding")
        if cached is not None:
            setattr(prop, "propagate_op_sharding", _Forwarding(cached, self._shadowed(cached)))
            self._patched.append((prop, "propagate_op_sharding", cached))
        return super().__enter__()

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._patched):
            setattr(owner, name, real)
        self._patched.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it to local ops and collectives
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        self.ops += 1
        self._count(func, args, kwargs, out)
        if self.track_memory:
            self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", str(func)).split(".")[-1]
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        c = self.cost
        kind = _COLL.get(name)
        if kind is not None:
            c.coll[kind] += sum(_nbytes(t) for t in ins)
        if name in _MATMUL and outs:
            f = _matmul_flops(name, args, outs[0])
            c.flops += f
            self.matmul_flops += f
        elif name in ARITH:
            c.flops += sum(t.numel() for t in outs)
        if name in _SKIP_BYTES or getattr(func, "is_view", False) or not (ins or outs):
            return
        if name == "copy_":
            c.bytes += 2.0 * _nbytes(args[1])
        elif name in ("index_put_", "index_put", "_index_put_impl_"):
            c.bytes += 2.0 * _nbytes(args[2]) + sum(_nbytes(i) for i in _tensors(args[1]))
        elif name in ("scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
                      "scatter_reduce_"):
            src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
            upd = _nbytes(src) if src is not None else _nbytes(args[2])
            c.bytes += 2.0 * upd + _nbytes(args[2])
        elif name in ("fill_", "zero_"):
            c.bytes += _nbytes(args[0])
        else:
            c.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
