"""Process start to the first measured call: kernel load, inputs from the
seed, witness builds, the key and the warm-up."""


def read(spec, data):
    return data.setup_s
