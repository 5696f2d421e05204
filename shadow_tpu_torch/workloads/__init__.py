"""Traffic sources of the port (counterpart of `shadow_tpu/workloads`)."""
