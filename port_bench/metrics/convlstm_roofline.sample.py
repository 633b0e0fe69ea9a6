"""Share of its roofline of the ConvLSTM kernels in a rollout of a
closed-loop sampling job: the least time of the required work
(``roofline.rollout_work``) over their device time."""

from port_bench.readers import kind, roofline_percent


def read(rec):
    return roofline_percent(rec, "convlstm") if kind(rec) == "sample" else None
