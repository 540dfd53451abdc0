"""attn_bwd_roofline.train: the causal attention backward's least time
(five dots; ``core.work.attn_bwd_work``) of the traced steps, over the
device time of the kernels that ``kernels/attn_bwd/`` names."""

from perfbench.core.readers import roofline_pct


def read(record):
    if record.get("kind") != "train":
        return None
    return roofline_pct(record, "attn_bwd")
