"""Slice conformance for small_cnn (the checks and their tolerances are in
test_torch_slice.py).  small_cnn has no global pool, so every activation
and the logits are bit-equal to the reference's eager path — and to its
compiled ServingEngine, which equals its eager path on this network."""
from test_torch_slice import SliceSuite


class TestSmallCnn(SliceSuite):
    NAME = "small_cnn"
