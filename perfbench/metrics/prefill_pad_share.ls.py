"""Percent of the tokens the LS tenant's prefill calls computed that sat
in rows at the write sentinel: each call runs all ``rows`` slots of the
pool for ``sq`` tokens, and only the rows of the chunk group serve. An
exact count over the calls that ended in the window."""
from perfbench.layers import pad_share


def read(run):
    return pad_share(run, "LS")
