"""Runnable examples of the port (`python -m ray_tracing_in_one_weekend_tpu_torch.examples.<name>`)."""
