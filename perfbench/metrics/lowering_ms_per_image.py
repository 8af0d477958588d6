"""Device time outside the TAOM kernels per served image in the traced
stretch, in ms: im2col, padding, pools, residual adds, the global mean,
the depthwise block-diagonal expansion, and the copies in and out of the
captured graphs (every device operation whose name does not hold
``taom_gemm``, summed over the cell's cards)."""


def read(run):
    images = run.images(run.traced)
    if run.trace is None or not images or not run.trace.other_s:
        return None
    return 1e3 * run.trace.other_s / images
