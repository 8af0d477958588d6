"""Distribution over ``torch.distributed`` (counterpart of
``repro.parallel``); ``sharding`` states how ranks execute."""
