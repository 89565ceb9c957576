"""PyTorch and CUDA port of super_resolution_tpu, for NVIDIA Hopper.

The JAX package beside it (``super_resolution_tpu``) is the reference this
port is held against. This package imports ``torch`` and never ``jax``:
the numpy-only helpers it shares with the JAX package are copied, not
imported, because importing anything from ``super_resolution_tpu`` pulls
in JAX.

Layout (NHWC activations throughout, as in the JAX package):

- ``csrc/``: hand-written CUDA C++ kernels for sm_90a, built with nvcc on
  first use (``ops/cuda_build.py``), and RawPack's host-side reader
  (``rawpack.cpp``), built with g++ on first use (``native.py``).
- ``ops/``: the kernel wrappers (``cuda_attention.py``, ``cuda_ffn.py``,
  ``cuda_hab.py``, ``cuda_window_attention.py``) with their plain PyTorch
  versions, and the tensor helpers.
- ``models/``: the classic HAT, the fork's HAT, ESC and the other archs
  under their checkpoints' names; the U-Net discriminator and VGG19.
- ``convert/``: the bridge from JAX/flax parameters to a state_dict.
- ``runtime/``: the tiled-inference engine and its shape-bucketed form
  across images (``batched_eval.py``), the runners (inference, validation,
  the x8 self-ensemble and training, the real-world GAN runners among
  them) and the test and train pipelines.
- ``data/``, ``losses/``, ``metrics/``: the datasets (folders, LMDB,
  RawPack) and loaders, the training losses, PSNR / SSIM (numpy and
  batched on the device), NIQE.
- ``utils/``: options, logging, image IO, the storage backends
  (``file_client.py``, ``mdb.py``, ``lmdb_util.py``), the
  ``torch.profiler`` trace windows (``profiler.py``), curve readers.
- ``tools/``: folder inference, folder-against-folder metrics
  (``eval_folder.py``), RawPack packing (``pack_dataset.py``), and
  profiles of a forward and of a real-world training iteration.
- ``predict.py``: the serving entry point; ``test.py``, ``train.py``: the
  test and train CLIs.
"""
