"""MD host loop: device idle ms a step in the gaps of the recorded pass
that open while the host is inside a `sync` span, each until the next
kernel or copy starts: the queue drained because the host waited
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    return spans.ms_per_step(p, spans.sync_idle_ns(p)) if p else None
