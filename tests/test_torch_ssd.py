"""The port's SSD scan (``repro_torch.kernels``) against the reference's.

Inputs are made from a seed with numpy and handed to both packages.  The
reference runs its Pallas kernel in interpret mode (``ssd_scan(impl=
"pallas")`` on the CPU) and its naive per-token oracle; the port runs its
plain chunked version (``impl="ref"``), its kernel wrapper (which takes
the plain version for CPU tensors) and its own naive oracle.  Tolerance:
rtol = atol = 1e-4, as the reference holds its own kernel
(tests/test_kernels.py) — the chunked and per-token forms sum in other
orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, ssd_scan

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(bh, l, p, s, seed):
    """The reference test's distributions: x, b, c ~ N(0, 1),
    dt = softplus(N(0, 1)), a = -exp(N(0, 1))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, l, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((bh, l)), 0.0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(bh))).astype(np.float32)
    b = rng.standard_normal((bh, l, s)).astype(np.float32)
    c = rng.standard_normal((bh, l, s)).astype(np.float32)
    return x, dt, a, b, c


def _torch(arrays):
    return [torch.from_numpy(v) for v in arrays]


def _naive_jax(x, dt, a, b, c):
    ys, states = [], []
    for i in range(x.shape[0]):
        y, st = jref.ssd_scan_reference(
            jnp.asarray(x[i][:, None, :]), jnp.asarray(dt[i][:, None]),
            jnp.asarray(a[i][None]), jnp.asarray(b[i][:, None, :]),
            jnp.asarray(c[i][:, None, :]))
        ys.append(np.asarray(y)[:, 0])
        states.append(np.asarray(st)[0])
    return np.stack(ys), np.stack(states)


def _naive_torch(x, dt, a, b, c):
    ys, states = [], []
    for i in range(x.shape[0]):
        y, st = ref.ssd_scan_reference(x[i][:, None, :], dt[i][:, None],
                                       a[i][None], b[i][:, None, :],
                                       c[i][:, None, :])
        ys.append(y[:, 0])
        states.append(st[0])
    return torch.stack(ys).numpy(), torch.stack(states).numpy()


CASES = [(2, 32, 8, 16, 8), (3, 40, 16, 24, 16), (1, 128, 64, 32, 128),
         (2, 33, 8, 8, 16),                  # ragged L -> padding path
         (1, 256, 64, 128, 128),             # mamba2-130m head and state
         (1, 256, 128, 32, 128),             # the largest head, P = 128
         (2, 300, 16, 16, 100),              # Q = 100, not a multiple of 4
         (2, 64, 8, 12, 64)]                 # a single chunk, L == Q


@pytest.mark.parametrize("bh,l,p,s,chunk", CASES)
def test_plain_ssd_scan_matches_reference(bh, l, p, s, chunk):
    arrays = _inputs(bh, l, p, s, seed=l + p)
    y_pl, st_pl = jops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                                impl="pallas")
    y_nv, st_nv = _naive_jax(*arrays)
    for impl in ("ref", "auto", "kernel"):
        y, st = ops.ssd_scan(*_torch(arrays), chunk=chunk, impl=impl)
        assert y.shape == (bh, l, p) and st.shape == (bh, p, s)
        assert y.dtype == torch.float32 and st.dtype == torch.float32
        for want_y, want_st in ((y_pl, st_pl), (y_nv, st_nv)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                       err_msg=impl, **TOL)
            np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                       err_msg=impl, **TOL)


@pytest.mark.parametrize("bh,l,p,s", [(2, 24, 8, 12), (1, 40, 16, 24)])
def test_naive_oracle_matches_reference(bh, l, p, s):
    arrays = _inputs(bh, l, p, s, seed=7)
    y, st = _naive_torch(*_torch(arrays))
    y_j, st_j = _naive_jax(*arrays)
    np.testing.assert_allclose(y, y_j, **TOL)
    np.testing.assert_allclose(st, st_j, **TOL)


def test_decode_step_matches_reference():
    x, dt, a, b, c = _inputs(3, 1, 8, 12, seed=3)
    st0 = np.random.default_rng(4).standard_normal((3, 8, 12)) \
        .astype(np.float32)
    args = (st0, x[:, 0], dt[:, 0], a, b[:, 0], c[:, 0])
    y_j, st_j = jops.ssd_decode_step(*map(jnp.asarray, args))
    y, st = ops.ssd_decode_step(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 16])
def test_decode_step_continues_half_prefill(chunk):
    # Scanning [0:L] must equal scanning [0:L/2] then continuing with the
    # decode step over the second half.
    bh, l, p, s = 2, 32, 8, 12
    x, dt, a, b, c = _torch(_inputs(bh, l, p, s, seed=11))
    y_full, st_full = ops.ssd_scan(x, dt, a, b, c, chunk=chunk)
    h = l // 2
    _, st = ops.ssd_scan(x[:, :h], dt[:, :h], a, b[:, :h], c[:, :h],
                         chunk=chunk)
    ys = []
    for t in range(h, l):
        yt, st = ops.ssd_decode_step(st, x[:, t], dt[:, t], a, b[:, t],
                                     c[:, t])
        ys.append(yt)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               y_full[:, h:].numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_full.numpy(), **TOL)


@pytest.mark.parametrize("l,chunk", [(33, 16), (1000, 128)])
def test_ragged_padding_leaves_final_state(l, chunk):
    # Zero padding (dt = 0: decay 1, no update) changes neither y's rows
    # nor the final state: compare with a chunk that divides L exactly.
    bh, p, s = 2, 8, 8
    arrays = _torch(_inputs(bh, l, p, s, seed=l))
    exact = next(q for q in range(chunk, 0, -1) if l % q == 0)
    y, st = ops.ssd_scan(*arrays, chunk=chunk)
    y_e, st_e = ops.ssd_scan(*arrays, chunk=exact)
    assert y.shape == (bh, l, p)
    np.testing.assert_allclose(st.numpy(), st_e.numpy(), **TOL)
    np.testing.assert_allclose(y.numpy(), y_e.numpy(), **TOL)


def test_kernel_wrapper_on_cpu_runs_the_plain_version():
    arrays = _torch(_inputs(2, 16, 8, 8, seed=1))
    before = ssd_scan.LAUNCHES
    y, st = ssd_scan.ssd_scan_chunked(*arrays, chunk=8)
    want_y, want_st = ops._ssd_chunked(*arrays, 8)
    assert torch.equal(y, want_y) and torch.equal(st, want_st)
    assert ssd_scan.LAUNCHES == before          # no kernel was launched
    assert ssd_scan._LIB is None                # nothing was built


def test_kernel_wrapper_rejects_bad_inputs():
    x, dt, a, b, c = _torch(_inputs(2, 16, 8, 8, seed=1))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan.ssd_scan_chunked(x, dt, a, b, c, chunk=6)
    with pytest.raises(ValueError, match="dt has shape"):
        ssd_scan.ssd_scan_chunked(x, dt[:, :8], a, b, c, chunk=8)
    with pytest.raises(ValueError, match="impl"):
        ops.ssd_scan(x, dt, a, b, c, chunk=8, impl="pallas")
    meta = [t.to("meta") for t in (x, dt, a, b, c)]
    with pytest.raises(ValueError, match="no SSD kernel"):
        ssd_scan.ssd_scan_chunked(*meta, chunk=8)
