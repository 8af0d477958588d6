"""Runtime supervision (counterpart of ``repro.runtime``)."""
