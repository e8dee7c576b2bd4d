"""Share of the TTA window in the program's norm spans: device seconds
of op.layer_norm, op.rms_norm and op.modulate (forward and remat recompute;
backward kernels sit in no op span)."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "op.layer_norm", "op.rms_norm", "op.modulate")
