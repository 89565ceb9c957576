"""setup_s: seconds from the start of the run's process to the end of its
warm-up (loading, the kernels' build where the checkout has none, seeded
weights, every shape of the mix served twice), by the host clock."""


def read(r):
    return r.setup_s
