"""Wall milliseconds an op: the window over the ops completed in it. On several cards the window is
rank 0's, from a barrier after warm-up to a barrier after every rank synchronised, over the ops
every rank completed."""


def read(rec):
    return 1000.0 * rec["window_s"] / rec["ops"] if rec["ops"] else None
