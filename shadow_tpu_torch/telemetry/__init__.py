"""The presence planes of observability: counters (`metrics`) and log2
histograms (`histo`)."""
