"""Model FLOPs (``flops.rollout_flops``) of the trace run's untraced
rollouts of a closed-loop sampling job, over their time on the host's
clock, as a percent of the H100's dense bf16 peak."""

from port_bench.flops import rollout_flops
from port_bench.readers import kind
from port_bench.roofline import PEAK_BF16


def read(rec):
    if kind(rec) != "sample":
        return None
    flops = rollout_flops(rec["reference"], rec["cfg"], rec["batch"])
    return 100.0 * flops * rec["timed_units"] / rec["timed_s"] / PEAK_BF16
