"""Words the collective moved per product in the window
(``Loopback.items_moved`` of every handle's executor)."""


def read(run):
    return run.moved_items / run.tally.products if run.tally.products else None
