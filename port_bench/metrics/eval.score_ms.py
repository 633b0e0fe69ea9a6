"""Device-timed milliseconds a rollout of a best-of-K request outside its
rollout calls (the scoring and the copies): CUDA events around each
request and each rollout call, from the benchmark's wrapper of the
rollout callable."""


def read(rec):
    if rec["driver"] != "sample" or not rec["traffic"]["metrics_k"]:
        return None
    rest = sum(req - sum(rolls) for req, rolls in rec["requests"])
    return rest / sum(len(rolls) for _, rolls in rec["requests"])
