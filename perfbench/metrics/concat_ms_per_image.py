"""Device time of the channel concats per served image in the traced
stretch, in ms: every device operation named ``CatArrayBatchedCopy*``
(PyTorch's ``cat`` kernels) on the cell's cards, over the images served
there.  On the fused route no im2col matrix is concatenated, so these
are the graph's ``concat`` nodes, and the global mean's few cats of an
odd number of positions."""

CAT = "CatArrayBatchedCopy"


def read(run):
    images = run.images(run.traced)
    if run.trace is None or not images:
        return None
    seconds = run.trace.seconds(lambda name: CAT in name)
    if not seconds:
        return None
    return 1e3 * seconds / images
