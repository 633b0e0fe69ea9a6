"""Model FLOPs (``flops.train_step_flops``, of the global batch) of the
trace run's untraced training steps, over their time on the host's
clock, as a percent of the dense bf16 peak of the H100s that share the
step."""

from port_bench.flops import train_step_flops
from port_bench.roofline import PEAK_BF16


def read(rec):
    if rec["driver"] != "train":
        return None
    flops = train_step_flops(rec["reference"], rec["cfg"], rec["batch"])
    return 100.0 * flops * rec["timed_units"] / rec["timed_s"] / (PEAK_BF16 * rec.get("ranks", 1))
