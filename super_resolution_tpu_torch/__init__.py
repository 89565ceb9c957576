"""PyTorch and CUDA port of super_resolution_tpu, for NVIDIA Hopper.

The JAX package beside it (``super_resolution_tpu``) is the reference this
port is held against. This package imports ``torch`` and never ``jax``:
the numpy-only helpers it shares with the JAX package are copied, not
imported, because importing anything from ``super_resolution_tpu`` pulls
in JAX.

Layout (NHWC activations throughout, as in the JAX package):

- ``csrc/``: hand-written CUDA C++ kernels for sm_90a, built with nvcc on
  first use (``ops/cuda_build.py``).
- ``ops/``: the kernel wrappers (``cuda_attention.py``, ``cuda_ffn.py``,
  ``cuda_hab.py``, ``cuda_window_attention.py``) with their plain PyTorch
  versions, and the tensor helpers.
- ``models/``: the classic HAT, the fork's HAT, ESC and the other archs
  under their checkpoints' names; the U-Net discriminator and VGG19.
- ``convert/``: the bridge from JAX/flax parameters to a state_dict.
- ``runtime/``: the tiled-inference engine, the runners (inference,
  validation and training, the real-world GAN runners among them) and the
  test and train pipelines.
- ``data/``, ``losses/``, ``metrics/``: the datasets and loaders, the
  training losses, PSNR / SSIM.
- ``tools/``: folder inference, and profiles of a forward and of a
  real-world training iteration.
- ``predict.py``: the serving entry point; ``test.py``, ``train.py``: the
  test and train CLIs.
"""
