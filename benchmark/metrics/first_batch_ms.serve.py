"""Mean of the Predictor's own all_time[0] (ms) over the window's clips: the
first batch of a clip runs alone, with the clip's pinning, upload, forward
and flush."""


def read(rec):
    if rec["kind"] != "serve" or not rec["first_batch_ms"]:
        return None
    return sum(rec["first_batch_ms"]) / len(rec["first_batch_ms"])
