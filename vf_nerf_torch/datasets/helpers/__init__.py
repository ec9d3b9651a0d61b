"""Offline data-conversion helpers (port of
``vf_nerf_tpu/datasets/helpers``; reference ``datasets/helpers/``): the
COLMAP model reader and its IDR camera conversion, the LLFF loader and the
pose utilities, host numpy."""
