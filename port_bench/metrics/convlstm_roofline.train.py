"""Share of its roofline of the ConvLSTM kernels in a training step:
the least time of the required work (``roofline.train_work``) over their
device time."""

from port_bench.readers import roofline_percent


def read(rec):
    return roofline_percent(rec, "convlstm") if rec["driver"] == "train" else None
