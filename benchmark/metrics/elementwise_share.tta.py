"""Share of the TTA window's kernel time in kernels the frozen kernel_kind
classes as elementwise (norms, RoPE, casts, the loss, the optimizer)."""

from benchmark.readers import kind_share


def read(run):
    return kind_share(run, "elementwise")
