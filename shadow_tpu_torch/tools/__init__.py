"""Command-line tools of the port (`python -m shadow_tpu_torch.tools.<name>`)."""
