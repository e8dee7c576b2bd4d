"""Share of the continuation window in building the conditioning KV cache,
from CUDA events at the sampler's on_phase marks."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, "cond_cache")
