"""setup_s: from the harness's start to the window's: loading the
program and its kernels, making and uploading the dives, and the warm-up
dive that captures the graphs of the cell's own keys."""


def read(run):
    return run.setup_s
