"""Property tests: the port's quantize and ADC equal the reference's bit
for bit on generated inputs, half-way ties included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.taom import quantize as jquantize  # noqa: E402
from repro.kernels.taom_gemm import adc_round as jadc_round  # noqa: E402

from repro_torch.core.taom import quantize as tquantize  # noqa: E402
from repro_torch.kernels.taom_gemm import adc_round as tadc_round  # noqa: E402


@settings(max_examples=60, deadline=None)
@given(bits=st.integers(2, 10), exp=st.integers(-6, 6),
       halves=st.lists(st.integers(-4000, 4000), min_size=1, max_size=40),
       per_channel=st.booleans())
def test_quantize_matches_reference(bits, exp, halves, per_channel):
    # Multiples of 2^(exp-1): with a power-of-two scale many entries land
    # exactly half-way between two integers.
    x = (np.array(halves, np.float64) * 2.0 ** (exp - 1)).astype(np.float32)
    x = np.stack([x, -x[::-1]], axis=1)
    axis = 0 if per_channel else None
    jq, js = jquantize(jnp.asarray(x), bits, axis=axis)
    tq, ts = tquantize(torch.from_numpy(x), bits, axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@settings(max_examples=60, deadline=None)
@given(adc_bits=st.integers(2, 12),
       fs=st.floats(1e-3, 1e7, allow_nan=False),
       steps=st.lists(st.integers(-5000, 5000), min_size=1, max_size=40),
       jitter=st.floats(-0.5, 0.5))
def test_adc_round_matches_reference(adc_bits, fs, steps, jitter):
    step = 2.0 * fs / ((1 << adc_bits) - 1)
    v = ((np.array(steps, np.float64) * 0.5 + jitter) * step).astype(
        np.float32)
    got = tadc_round(torch.from_numpy(v), adc_bits, fs).numpy()
    want = np.asarray(jadc_round(jnp.asarray(v), adc_bits, fs))
    np.testing.assert_array_equal(got, want)
