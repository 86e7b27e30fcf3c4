"""Serving on the port: prefill/decode steps and the batching engine."""
