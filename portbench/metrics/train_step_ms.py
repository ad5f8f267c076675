"""Wall time of the window over the training steps completed in it (ms)."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["window_s"] / rec["steps"] * 1e3
