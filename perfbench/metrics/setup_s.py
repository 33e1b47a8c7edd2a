"""Seconds from process start to the window's first op: imports, builds, data, warm-up."""


def read(rec):
    return rec["setup_s"]
