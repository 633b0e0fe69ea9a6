"""Host milliseconds a step the training loop waited for its next batch
(``Trainer.timings["prefetch_wait"]``), over the traced steps."""


def read(rec):
    if rec["driver"] != "train":
        return None
    return rec["prefetch_wait_ms"] / rec["units"]
