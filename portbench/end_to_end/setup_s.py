"""setup_s: process start to the window's first call: imports, the CUDA
context, the kernel library (built at a checkout's first run, loaded from
cudasbmp_torch/_build/ after), the planner and one warm call at the cell's
shapes."""


def read(window):
    return window.setup_s
