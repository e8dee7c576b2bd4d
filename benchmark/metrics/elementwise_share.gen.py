"""Share of the continuation window's kernel time in kernels the frozen
kernel_kind classes as elementwise."""

from benchmark.readers import kind_share


def read(run):
    return kind_share(run, "elementwise")
