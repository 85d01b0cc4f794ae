"""Process start to the first timed request: imports, the CUDA context,
the weights and inputs made from the seed, the kernels' build (the first
run of a checkout) and the warm-up of the cell's shapes."""


def read(rec):
    return rec["setup_s"]
