"""The device network plane in PyTorch (counterpart of `shadow_tpu/tpu`)."""
