"""From the process's start to the window's: imports, the card's context,
the weights drawn and bound, the kernels loaded from the build directory,
the step captured, the cell's shapes run once."""


def read(run):
    return run.setup_s
