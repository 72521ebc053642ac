"""Optimizers over parameter trees (torch port of ``repro.optim``)."""
