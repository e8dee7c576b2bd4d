"""Latent-frame bucket ladder (the reference's ``tta/bucket.py``): a
generated horizon (``generate_vc(bucket_gen=True)``) or a TTA target
(``--bucket-shapes``, ``pad_target_latents``) is padded up to its bucket
and the padding is masked out of attention by a valid count, and out of
the MSE (``tta/losses.py``'s ``num_valid_target``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# latent-frame bucket ladder (target side)
DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 6, 8, 12, 16, 20, 26, 32)


def bucket_len(t: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= t (exact t if it exceeds the ladder)."""
    for b in buckets:
        if b >= t:
            return b
    return t


def pad_target_latents(latents: torch.Tensor,
                       buckets: Sequence[int] = DEFAULT_BUCKETS
                       ) -> Tuple[torch.Tensor, int]:
    """Pad the latent T axis of [B, C, T, H, W] up to its bucket with
    zeros -> (padded [B, C, T_bucket, H, W], valid count T). The pad is
    masked everywhere downstream, so any content works."""
    t = latents.shape[2]
    tb = bucket_len(t, buckets)
    if tb > t:
        latents = torch.nn.functional.pad(latents, (0, 0, 0, 0, 0, tb - t))
    return latents, t
