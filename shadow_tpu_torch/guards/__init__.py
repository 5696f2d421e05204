"""The guard plane (counterpart of `shadow_tpu/guards`): the device
invariant checks (`plane`) and the structured violations and report
(`report`)."""
