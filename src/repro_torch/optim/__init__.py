"""Optimizers of the port: AdamW in its float32 and 8-bit state modes."""
