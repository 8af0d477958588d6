"""Optimizers (counterpart of ``repro.optim``): AdamW."""
