"""Per-layer metrics, one reader a file, found by the metric's name.

`portbench/metrics/<name>.py` defines `read(ctx) -> float | None` over
the traced run's `Context`; None where it finds nothing to read (the
harness then leaves the metric out of the line). A share of a roofline or
of a peak is never reported as 0 in place of nothing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Context:
    trace: object  # portbench.trace.Trace of the profiled chunks
    steps: int  # MD steps the profiled chunks took
    regrows: int  # capacity regrows over the whole window
    work: dict  # counts.neighbors.work, the mean over the profiled span
    cfg: dict  # the configuration file
    tables: dict  # counts.work.load(config)
    groups: list  # counts.work.groups()


def read(name: str, ctx: Context):
    path = os.path.join(HERE, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)
