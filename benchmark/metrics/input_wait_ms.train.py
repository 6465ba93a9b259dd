"""Mean ms a step of `fit` spent inside the pipeline's get_batch in the
window, timed by the benchmark's feed around it."""


def read(rec):
    if rec["kind"] != "train" or not rec["waits_ms"]:
        return None
    return sum(rec["waits_ms"]) / len(rec["waits_ms"])
