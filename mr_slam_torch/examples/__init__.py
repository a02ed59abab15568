"""Runnable examples of the PyTorch port (`python -m
mr_slam_torch.examples.<name>`)."""
