"""Training checkpoints (torch port of ``repro.checkpoint``)."""
