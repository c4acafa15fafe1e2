"""AEV glue: device ms a step of the kernels and copies outside the asn
and MLP name groups (counts/groups.json) launched inside the program's
`aev_forward` or `aev_backward` spans (`_AsnFused`) in the recorded pass:
the gathers, pads and folds around the asn kernels (portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    if p is None:
        return None
    by = spans.device_ns_by_layer(p, ctx.groups)
    return spans.ms_per_step(p, by["aev"]["glue"])
