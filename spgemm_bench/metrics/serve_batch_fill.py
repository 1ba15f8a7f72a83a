"""Share of the batch slots the server dispatched in the window that carried
a request (``ServeStats.batch_items / batch_slots``), %."""


def read(run):
    if run.batch is None or not run.batch[1]:
        return None
    items, slots = run.batch
    return 100.0 * items / slots
