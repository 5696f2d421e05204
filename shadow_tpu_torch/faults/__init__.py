"""The fault plane (counterpart of `shadow_tpu/faults`): the compiled
`faults:` schedule (`schedule`) and the device masks it uploads
(`plane`), and the checkpoints (`checkpoint`: the file formats;
`runstate`: full-run checkpoint and resume)."""
