"""Set-up: from the process's start to the window's, through the keys and
the pool drawn, the build, the planes and their upload, the kernels' load
(their build in a fresh checkout) and the warm-up."""


def read(run):
    return run.setup_s
