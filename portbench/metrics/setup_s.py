"""Process start to the start of the window (host clock): loading, the
kernels' build or load, signing or loading the traffic, warming up."""


def read(run):
    return run.setup_s
