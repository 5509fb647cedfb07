"""build_s (s, host clock): the facade's build, from the call to a device
synchronise after it."""


def read(run):
    return run.build_s
