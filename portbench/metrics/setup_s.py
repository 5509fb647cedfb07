"""setup_s (s, host clock): from the start of ``run.py`` to the end of the
warm-up: imports, the device, the data, the build, the kernels' loading
(or, in a checkout's first run, their compilation) and the warm-up
requests."""


def read(run):
    return run.setup_s
