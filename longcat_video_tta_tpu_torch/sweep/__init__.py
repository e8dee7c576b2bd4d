"""YAML sweeps over the port's runner and their post-processing
(counterparts of ``longcat_video_tta_tpu/sweep/``)."""
