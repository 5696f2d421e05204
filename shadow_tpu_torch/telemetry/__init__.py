"""Observability: the presence planes (counters `metrics`, log2
histograms `histo`, the flight recorder `flightrec`) and the host side
that reads them (the heartbeat harvester `harvest`, the exporters
`export`, the run ledger `tracer`)."""
