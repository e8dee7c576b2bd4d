"""Latent-frame bucket ladder (the reference's ``tta/bucket.py``): a
generated horizon is padded up to its bucket and the padding is masked
out of attention by a valid count (``generate_vc(bucket_gen=True)``)."""

from __future__ import annotations

from typing import Sequence, Tuple

# latent-frame bucket ladder (target side)
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 6, 8, 12, 16, 20, 26, 32)


def bucket_len(t: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= t (exact t if it exceeds the ladder)."""
    for b in buckets:
        if b >= t:
            return b
    return t
