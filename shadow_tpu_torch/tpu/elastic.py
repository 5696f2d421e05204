"""The chained-window driver loop, fixed-capacity form (counterpart of
`shadow_tpu/tpu/elastic.py` `chain_spans` / `drive_chained_windows`,
without the capacity policy, memo, tracer, checkpointer or hooks)."""

from __future__ import annotations


def chain_spans(n_rounds: int, chain_len: int) -> list[tuple[int, int]]:
    """[0, n_rounds) split at every `chain_len` multiple, as [r0, r1)
    pairs."""
    if chain_len < 1:
        raise ValueError(f"chain_len must be >= 1, got {chain_len}")
    edges = sorted({0, n_rounds, *range(chain_len, n_rounds, chain_len)})
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def drive_chained_windows(state, extras, chain_fn, *, n_rounds: int,
                          chain_len: int):
    """Run `chain_fn(state, extras, r0, r1) -> (state', extras')` over
    the chain spans. A chain is the caller's Python loop of windows
    r0..r1-1 that reads the device back once, at its end; the host
    regains control only between chains. Returns the final
    (state, extras)."""
    for r0, r1 in chain_spans(n_rounds, chain_len):
        state, extras = chain_fn(state, extras, r0, r1)
    return state, extras
