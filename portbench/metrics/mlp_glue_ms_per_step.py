"""MLP ensemble: device ms a step of the kernels and copies outside the
asn and MLP name groups (counts/groups.json: not the matrix products)
launched inside the program's `nn_forward` span, or inside `grad` outside
`aev_backward`, in the recorded pass: the CELUs and their gradients, the
ensemble mean, the weight-row gathers, the strain's few kernels
(portbench/spans.py)."""

from portbench import spans


def read(ctx):
    p = spans.of(ctx)
    if p is None:
        return None
    by = spans.device_ns_by_layer(p, ctx.groups)
    return spans.ms_per_step(p, by["mlp"]["glue"])
