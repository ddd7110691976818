"""The share of the traced window the card sat idle in gaps begun inside
one of the port's `rt.sync.*` spans: a device->host read, a pageable
host->device copy or a synchronize. With `idle_program_pct` and
`idle_client_pct` it adds up to `idle_pct`."""

from rtbench import spans


def read(trace):
    split = spans.idle_split(trace)
    return None if split is None else split["sync"]
