"""Seconds from the process's start to the window: structures, planning,
compiling (the nvcc build in a checkout's first run), values and warm-up."""


def read(run):
    return run.setup_s
