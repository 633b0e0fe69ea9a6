"""Device milliseconds a rollout of every kernel that is not one of the
port's (``kernels/*.json``) in a closed-loop sampling job: cuDNN convs,
norms, elementwise, the scoring."""

from port_bench.readers import family_seconds, kind


def read(rec):
    if kind(rec) != "sample":
        return None
    return 1e3 * family_seconds(rec, None) / rec["units"]
