"""Test-time adaptation: adapter schemes, flow-matching losses, the
optimizer and train loop, anchored early stopping, the TTA window split
and the CLIP gate in front of it (counterpart of
``longcat_video_tta_tpu/tta``)."""
