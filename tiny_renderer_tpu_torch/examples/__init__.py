"""Runnable examples of the torch port (``python -m tiny_renderer_tpu_torch.examples.<name>``)."""
