"""The products' share of their roofline, %: the least time of the window's
requests (reads, and the dense C written once; ``roofline.py``) over the
window's seconds.  The window runs the bare program in a traced run too."""


def read(run):
    least = run.least_s("product")
    if least is None or run.window_s <= 0:
        return None
    return 100.0 * least * run.tally.requests / run.window_s
