"""The least time the card could take for an op: its operations and bytes,
counted from shapes, over the card's published peaks (``peaks.json``)."""
