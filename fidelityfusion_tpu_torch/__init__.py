"""PyTorch + CUDA port of `fidelityfusion_tpu` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(`ops/`, `models/`, `train/`, `utils/`, `experiments/`, `demo.py`) so each
counterpart sits at the same relative path.  It imports neither `jax` nor
anything of `fidelityfusion_tpu`.

Entry points take an explicit ``device`` (default ``"cuda"``).  On CUDA
tensors the hot operations launch hand-written kernels
(`fidelityfusion_tpu_torch/csrc/*.cu`, built with `nvcc` at first use);
on CPU tensors they run the plain PyTorch version of the same algorithm.
There is no silent fallback from one to the other.
"""
