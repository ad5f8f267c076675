"""Host wall a ``recognize_batch`` call, mean over the window (ms)."""


def read(rec):
    w = rec.get("batch_walls_s")
    return sum(w) / len(w) * 1e3 if w else None
