"""HR frames the sink received inside the window, over the window's seconds."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return rec["frames"] / rec["window_s"]
