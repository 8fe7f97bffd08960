"""Stage entry points (``python -m pistoseg_tpu_torch.stages.<stage>``)."""
