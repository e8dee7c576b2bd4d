"""Test-time adaptation: adapter schemes, flow-matching losses, the
optimizer and train loop, anchored early stopping, and the TTA window
split (counterpart of ``longcat_video_tta_tpu/tta``; only ``delta_a`` is
ported so far)."""
