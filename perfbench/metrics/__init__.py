"""One reader a quantity: ``metrics/<name>.py`` defines ``read(rec)``, which returns the metric's
value from a run's record (``harness.run_rank``), or None where the run gave it nothing to read.
A metric is read by the file of its whole name, or else of its name before the first dot (the
cell's qualifier: ``op_ms.x4`` by ``op_ms.py``), or else of that name without its leading words
(the kernel's: ``cdist_roofline`` by ``roofline.py``); ``harness.reader_path``."""
