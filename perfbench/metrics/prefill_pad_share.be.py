"""``prefill_pad_share.ls`` over the BE tenant's prefill calls."""
from perfbench.layers import pad_share


def read(run):
    return pad_share(run, "BE")
