"""``setup_s``: the run's set-up on the host's clock, from the process's
start (imports, the CUDA context, the kernels' load or build, the data,
the weights, the port's model and its warm-up) to the window's start."""


def read(window):
    return window.setup_s
