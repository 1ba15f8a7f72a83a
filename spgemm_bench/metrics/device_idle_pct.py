"""Share of the traced segment in which no operation ran on the device, %."""


def read(run):
    seg = run.segment
    if seg is None or seg["busy_s"] <= 0 or seg["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])
