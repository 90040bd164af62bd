"""LS launches of ``decode_attention_paged``: their summed least time
(``roofline.decode_attn_work`` of each call's served rows, one launch a
layer) over their summed device time in the profiled sub-window.
Percent."""
from perfbench.layers import attn_roofline


def read(run):
    return attn_roofline(run, "decode")
