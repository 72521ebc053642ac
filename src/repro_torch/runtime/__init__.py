"""Serving runtime: paged KV pools, slot scheduler, continuous-batching
engine."""
