"""areal_tpu_torch: the PyTorch/CUDA port of `areal_tpu`.

The module layout mirrors `areal_tpu/` so every module has a visible
counterpart there; inside the modules the code is PyTorch idiom. The
package imports `torch` and never `jax`, and nothing of `areal_tpu`: the
JAX package is the numerics reference the tests hold this one against.

Entry points run on the CUDA device (an sm_90 Hopper card) unless the
caller passes `device="cpu"`; only then do the ops run their plain PyTorch
versions instead of the hand-written kernels (`ops/csrc/`).
"""
