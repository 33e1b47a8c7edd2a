"""GiB allocated at the peak of the window, on the fullest card (max_memory_allocated after a reset
at the start)."""


def read(rec):
    return rec["peak_bytes"] / 2.0 ** 30
