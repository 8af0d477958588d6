"""Share of the traced stretch in which no operation ran on a card, the
mean over the cell's cards, in %.  Shared by ``device_idle_pct.offline``
and ``device_idle_pct.online``."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.mean_busy_s / run.trace.window_s)
