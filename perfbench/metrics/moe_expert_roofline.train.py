"""moe_expert_roofline.train: the routed experts' least time over the
traced steps (``core.moe_work.expert_work``: three GEMMs a held
assignment, forward and backward, recompute not counted, from the
program's count of the assignments), over the device time of the kernels
that ``kernels/moe_experts/`` names, launched inside the traced steps."""

from perfbench.core import moe_work, spec, trace, work


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "train" or "experts" not in record or not tr \
            or not tr["units"] or not tr.get("moe_assignments"):
        return None
    spans = [(u["t0"], u["t1"]) for u in tr["units"]]
    kernel_s = trace.matching_seconds(
        tr["ops"], spec.kernel_patterns("moe_experts"), spans)
    if kernel_s == 0:
        return None
    m, x = record["dims"], record["experts"]
    layer_steps = x.moe_layers(m) * len(tr["units"])
    least = work.least_seconds(*moe_work.expert_work(
        tr["moe_assignments"], layer_steps, m, x))
    return 100.0 * least / kernel_s
