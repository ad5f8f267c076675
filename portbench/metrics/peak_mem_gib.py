"""``torch.cuda.max_memory_allocated()`` over the window, after a reset at
its start (GiB)."""


def read(rec):
    b = rec.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
