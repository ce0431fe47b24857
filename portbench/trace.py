"""Reading a ``torch.profiler`` trace of the profiled rounds: device
operations, the device-side spans of the trainer's ``record_function``
ranges, the host's ranges, the device's busy time and its idle gaps.

The trace is exported as a chrome trace (written and parsed in C) into the
run's temporary directory and deleted once read: building the profiler's
Python event tree over every host op of a full-width round takes tens of
seconds.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    device: list  # (name, start ns, end ns) of every device operation
    gpu_ranges: list  # (name, start ns, end ns): device-side spans of annotations
    host_ranges: list  # (name, start ns, end ns): host-side annotations

    def span_s(self, name: str) -> float:
        """Seconds of the device-side spans of range ``name``, summed."""
        return sum(hi - lo for n, lo, hi in self.gpu_ranges if n == name) / 1e9

    def kernel_s(self, substrings) -> float:
        """Device seconds of the kernels whose name holds one of ``substrings``."""
        return sum(hi - lo for n, lo, hi in self.device
                   if any(s in n for s in substrings)) / 1e9

    def busy_intervals(self) -> list:
        spans = sorted((lo, hi) for _, lo, hi in self.device)
        merged: list = []
        for lo, hi in spans:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return merged

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, lo, hi in self.device:
            total[name] = total.get(name, 0) + (hi - lo)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations, each named by
        the innermost host range open when it began."""
        busy = self.busy_intervals()
        gaps = [(b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        out = []
        for ns, start in gaps[:n]:
            open_ = [(hi - lo, name) for name, lo, hi in self.host_ranges if lo <= start < hi]
            out.append([min(open_)[1] if open_ else "no host range", ns / 1e9])
        return out


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events["traceEvents"] if isinstance(events, dict) else events
    device, gpu_ranges, host_ranges = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        lo = int(float(e["ts"]) * 1e3)
        item = (e.get("name", ""), lo, lo + int(float(e["dur"]) * 1e3))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat == "gpu_user_annotation":
            gpu_ranges.append(item)
        elif cat == "user_annotation":
            host_ranges.append(item)
    return Trace(device, gpu_ranges, host_ranges)
