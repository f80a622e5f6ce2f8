"""One-process training (``train/`` of the reference): the train step and
the fault-tolerant trainer."""
