"""setup_s: process start to the first timed step (host clock)."""


def read(rec, suffix):
    return rec.setup_s
