"""CUDA kernels an eval chunk enqueues: the traced window's kernel records
over its chunks (the view's host reads included)."""


def read(t):
    if t.unit != "chunk" or not t.units:
        return None
    return len(t.kernels) / t.units
