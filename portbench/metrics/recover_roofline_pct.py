"""The recovery kernel's share of its roofline in the window: the least time
the card could take for the recoveries of every lane the window took to the
card (the cell's ``window_lanes()``, counted by the frozen operation count of
``portbench/harness/roofline.py`` at the integer peak), over the time the
profiler gives the ``secp256k1_recover`` kernels.  It reads
``recover_roofline_pct.<x>`` for every cell that lists it."""


def read(run):
    if run.recover_bound_s is None:
        return None
    kernel_s = run.kernel_s("secp256k1_recover")
    if kernel_s <= 0:
        return None
    return 100.0 * run.recover_bound_s / kernel_s
