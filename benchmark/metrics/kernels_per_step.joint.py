"""CUDA kernels a joint step enqueues: the traced window's kernel records
over its joint steps (the supervision block's and the epoch-end reads'
kernels included)."""


def read(t):
    if t.unit != "joint_step" or not t.units:
        return None
    return len(t.kernels) / t.units
