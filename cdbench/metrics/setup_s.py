"""setup_s: seconds from process start to the first timed unit: imports,
the world made from the seed, the program's state and its warm units
(the first run in a checkout also builds the kernels)."""


def read(run):
    return run.setup_s
