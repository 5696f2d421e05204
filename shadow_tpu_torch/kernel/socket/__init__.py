"""Simulated sockets (inet UDP/TCP; unix later)."""
