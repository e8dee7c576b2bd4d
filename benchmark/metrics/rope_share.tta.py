"""Share of the TTA window in the program's RoPE spans: device seconds
of op.rope (forward and remat recompute)."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "op.rope")
