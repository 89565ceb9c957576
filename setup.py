from setuptools import find_packages, setup

setup(
    name="super_resolution_tpu",
    version="0.1.0",
    description="TPU-native (JAX/XLA/Pallas) super-resolution framework: "
                "HAT/ESC/SwinIR model families, on-device tiled inference, "
                "data-parallel training over device meshes",
    packages=find_packages(include=["super_resolution_tpu",
                                    "super_resolution_tpu.*",
                                    "super_resolution_tpu_torch",
                                    "super_resolution_tpu_torch.*"]),
    # the PyTorch port builds its CUDA kernels from these sources on first use
    package_data={"super_resolution_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                                "csrc/*.cpp",
                                                "metrics/*.npz"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "pyyaml"],
    extras_require={"io": ["opencv-python"], "torch-import": ["torch"]},
)
