"""CUDA kernels a training step enqueues: the traced window's kernel
records over its steps (the epoch-end reads included)."""


def read(t):
    if t.unit != "step" or not t.units:
        return None
    return len(t.kernels) / t.units
