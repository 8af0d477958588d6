"""Launchers (counterpart of ``repro.launch``): ``serve`` so far."""
