"""The TTA window's products (train steps and anchors, op counts of
opcount/<backbone>.py) at the published peaks over the window's time."""

from benchmark.readers import step_mfu


def read(run):
    return step_mfu(run)
