"""Per-layer metrics, one reader a file: ``metrics/<name>.py`` defines
``read(run) -> float | None`` over a :class:`portbench.harness.Traced`
(the profiled rounds' trace and the window's counts).  A reader that finds
nothing to read returns None, and the metric is left out of the line.

A quantity split by the end-to-end metric it moves (``fwd_bwd_ms`` and
``fwd_bwd_ms.s128``) shares the reader of the name before the first dot,
unless a file of its own full name exists."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / f"{name}.py"
    if not path.exists():
        path = HERE / f"{name.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
