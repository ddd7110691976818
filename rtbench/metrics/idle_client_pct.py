"""The share of the traced window the card sat idle in gaps begun inside
none of the port's spans: the benchmark client between and around the
port's calls. With `idle_sync_pct` and `idle_program_pct` it adds up to
`idle_pct`."""

from rtbench import spans


def read(trace):
    split = spans.idle_split(trace)
    return None if split is None else split["client"]
