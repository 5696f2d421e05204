"""Utility layer (parity: reference `src/main/utility/`)."""
