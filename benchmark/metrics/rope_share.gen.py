"""Share of the continuation window in the program's RoPE spans: device
seconds of op.rope."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "op.rope")
