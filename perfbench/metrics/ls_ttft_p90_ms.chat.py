"""``ls_ttft_p90_ms`` in the chat cell, held to no bound there: its runs
spread 8-16% within a set, more than a bound of at most 0.25 holds, and
the card is idle over half of its window (``PERF.md`` §2)."""
from perfbench.catalog import load_reader

read = load_reader("ls_ttft_p90_ms")
