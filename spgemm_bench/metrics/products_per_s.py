"""Products completed in the window per second of it (a Galerkin step is two)."""


def read(run):
    return run.tally.products / run.window_s if run.window_s > 0 else None
