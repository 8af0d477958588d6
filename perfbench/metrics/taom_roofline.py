"""The TAOM kernels' share of their roofline in the traced stretch, in %:
the least time of every served forward's GEMMs (``peaks.forward_bound_s``
over the layers' own work, at the images each card executes) over the
device time of the kernels named ``taom_gemm*`` on the cell's cards."""
from perfbench import peaks


def read(run):
    if run.trace is None or not run.trace.taom_s:
        return None
    bound = 0.0
    for r in run.traced:
        left = r.size
        while left > 0:
            images = run.bucket(min(left, run.max_batch))
            bound += run.cards * peaks.forward_bound_s(
                run.gemms, images // run.cards)
            left -= run.max_batch
    return 100.0 * bound / run.trace.taom_s
