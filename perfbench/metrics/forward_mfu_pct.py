"""The whole forward's share of the cards' int8 peak over the measured
window, in %: 2 x the network's own multiply-adds an image x the images
answered, over the window, over 1,979 TOP/s a card."""
from perfbench import peaks


def read(run):
    images = run.images(run.requests)
    if not images or not run.window_s:
        return None
    ops = 2.0 * peaks.useful_macs(run.gemms) * images
    return 100.0 * ops / run.window_s / (peaks.INT8_OPS_PER_S * run.cards)
