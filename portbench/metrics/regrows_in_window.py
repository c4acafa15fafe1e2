"""MD host loop: capacity regrows in the whole measured window
(`Simulation.regrow_events` at its end less at its start): each re-runs a
chunk."""


def read(ctx):
    return float(ctx.regrows)
