"""Share of the continuation window in the program's norm spans: device
seconds of op.layer_norm, op.rms_norm and op.modulate."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "op.layer_norm", "op.rms_norm", "op.modulate")
