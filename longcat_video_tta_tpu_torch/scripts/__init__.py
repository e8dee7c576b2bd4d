"""The science loop on the port (counterparts of the repository's
``scripts/`` drivers of the same names): pretraining the longcat_demo
stack, the synthetic towers, the demo and bench campaigns, the TTA
hyperparameter probe and the t2v prompt list. Each module runs as
``python3 -m longcat_video_tta_tpu_torch.scripts.<name>``."""
