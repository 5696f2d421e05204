"""Host-side policy of the port (counterpart of `shadow_tpu/core`)."""
