"""Host seconds from the structures to compiled handles, in set-up:
``repro_torch.plan`` and ``compile()`` for each product (loop cells), the
session's cold ``entry_for``, which plans and compiles (serving cells)."""


def read(run):
    return run.plan_s
