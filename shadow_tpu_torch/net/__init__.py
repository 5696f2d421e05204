"""The network graph and its routing tables (counterpart of
`shadow_tpu/net`, the parts the flow engine's plan needs)."""
