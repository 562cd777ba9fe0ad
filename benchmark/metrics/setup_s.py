"""setup_s: seconds from the start of the process to the first timed frame
(imports, CUDA start-up, the kernels' build at a checkout's first run, the
inputs made from the seed, the scene, the warm-up)."""


def read(run):
    return run.setup_s
