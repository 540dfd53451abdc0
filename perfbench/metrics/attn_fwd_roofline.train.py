"""attn_fwd_roofline: the causal attention forward's least time, counted
from the traced units' shapes (``core.work.attn_fwd_work``), over the device
time of the kernels that ``kernels/attn_fwd/`` names, in those units."""

from perfbench.core.readers import roofline_pct


def read(record):
    if record.get("kind") != "train":
        return None
    return roofline_pct(record, "attn_fwd")
