"""Share of the TTA window in the stopper's anchor evaluations (each
video's step-0 anchor and every check), from CUDA events at
train_chunk's on_phase marks."""

from benchmark.readers import span_share


def read(run):
    return span_share(run, "anchor_check", "setup_anchor")
