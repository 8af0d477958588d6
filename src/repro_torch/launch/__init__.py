"""Launchers (counterpart of ``repro.launch``): ``serve`` and ``train``."""
