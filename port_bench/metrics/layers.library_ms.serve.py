"""Device milliseconds a rollout of every kernel that is not one of the
port's (``kernels/*.json``) when serving requests: cuDNN convs, norms,
elementwise."""

from port_bench.readers import family_seconds, kind


def read(rec):
    if kind(rec) != "serve":
        return None
    return 1e3 * family_seconds(rec, None) / rec["units"]
