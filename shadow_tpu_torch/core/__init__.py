"""Host-side policy and the simulation driver of the port (counterpart
of `shadow_tpu/core`): the config, units, RNG and capacity policy, the
flow plan, and the Manager with its controller, scheduler, workers and
events."""
