"""All images answered in the measured window over the window, which runs
from the first send to the last answer."""


def read(run):
    if not run.window_s:
        return None
    return run.images(run.requests) / run.window_s
