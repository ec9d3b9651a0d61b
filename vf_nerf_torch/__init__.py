"""vf_nerf_torch: the PyTorch and CUDA port of vf_nerf_tpu for NVIDIA Hopper.

It imports ``torch`` and never ``jax`` or anything of ``vf_nerf_tpu``. Its
entry points run on CUDA unless the caller passes ``device="cpu"``. On CUDA
tensors the fused MLP and the fused ray march launch hand-written kernels
(``csrc/*.cu``, built by ``kernels.load_library`` at first use); on CPU
tensors they run their plain PyTorch versions.
"""
