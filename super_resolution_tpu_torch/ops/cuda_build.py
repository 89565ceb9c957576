"""Build, load and call the port's CUDA kernels.

The sources in ``csrc/`` are compiled with nvcc for sm_90a (one nvcc per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ctypes. The build runs on first use, from
the checkout alone, into ``_build/`` (listed in .gitignore); the library's
name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

Every wrapper dispatches on its input's device through :func:`use_kernel`:
a CPU tensor runs the plain PyTorch version, a CUDA tensor launches the
kernel or raises. Nothing falls back from one to the other. A kernel has no
backward of its own: a wrapper called for a gradient raises
(:func:`check_operands`), and the ``*_ad`` entries of the kernels that
training runs go through :func:`with_plain_backward` instead, whose
backward is autograd through the plain version (the JAX ``*_ad`` design).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# dynamic shared memory one block may be granted on sm_90 (227 KB)
MAX_DYNAMIC_SMEM = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of the C entry points (csrc/*.cu); each returns a cudaError_t
_SIGNATURES = {
    "sr_mlp_tail": [_I] + [_P] * 10 + [_I] * 7 + [_F] * 3 + [_P],
    "sr_mma_mlp_tail": [_P] * 10 + [_I] * 7 + [_F] * 3 + [_P],
    "sr_mma_mlp_tail_smem": [_I],
    "sr_msa_block": [_I] + [_P] * 7 + [_I] + [_P] * 2 + [_I] * 9 + [_F]
    + [_P],
    "sr_ocab_block": [_I] + [_P] * 12 + [_I] * 8 + [_F] * 3 + [_P],
    "sr_ln_split": [_I] + [_P] * 5 + [_I] * 3 + [_F] + [_P],
    "sr_ln_split_vec": [_P] * 5 + [_I] * 3 + [_F] + [_P],
    "sr_ln_split_vec_max_c": [],
    "sr_gated_dconv_ffn": [_I] + [_P] * 10 + [_I] * 8 + [_F] + [_P],
    "sr_gated_dconv_ffn_smem": [_I] * 3,
    "sr_mma_gated_dconv_ffn": [_P] * 10 + [_I] * 8 + [_F] + [_P],
    "sr_mma_gated_dconv_ffn_smem": [_I] * 2,
    "sr_ocab_attention": [_I] + [_P] * 4 + [_I] * 7 + [_F] + [_P],
    "sr_ocab_attention_smem": [_I] * 4,
    "sr_mma_ocab_attention": [_P] * 4 + [_I] * 7 + [_F] + [_P],
    "sr_msa_block_smem": [_I] * 2,
    "sr_ocab_block_smem": [_I] * 3,
    "sr_mma_ocab_block": [_P] * 14 + [_I] * 8 + [_F] * 3 + [_P],
    "sr_mma_ocab_block_smem": [_I] * 2,
    "sr_mma_msa_block": [_P] * 7 + [_I] + [_P] * 3 + [_I] * 9 + [_F] + [_P],
    "sr_mma_msa_block_smem": [_I] * 2,
    "sr_fused_attention": [_I] + [_P] * 5 + [_I] * 5 + [_F] + [_P],
    "sr_fused_attention_v3": [_I] + [_P] * 5 + [_I] * 5 + [_F] + [_P],
    "sr_window_attention_smem": [_I] * 2,
    "sr_mma_window_attention": [_P] * 5 + [_I] * 5 + [_F] + [_P],
    "sr_mma_window_attention_v3": [_P] * 5 + [_I] * 5 + [_F] + [_P],
    "sr_mma_flash_attention": [_P] * 3 + [_I] * 6 + [_F] + [_P],
    "sr_mma_qtile_attention": [_P] * 3 + [_I] * 6 + [_F] + [_P],
    "sr_mma_attention_smem": [_I],
    "sr_msa_flash_attention": [_I] + [_P] * 3 + [_I] * 6 + [_F] + [_P],
    "sr_msa_qtile_attention": [_I] + [_P] * 3 + [_I] * 6 + [_F] + [_P],
    "sr_msa_flash_smem": [_I],
    "sr_msa_qtile_smem": [_I] * 2,
    "sr_msa_attention": [_I] + [_P] * 3 + [_I] + [_P] + [_I] * 6 + [_F]
    + [_P],
    "sr_msa_attention_smem": [_I] * 2,
    "sr_mma_msa_attention": [_P] * 3 + [_I] + [_P] + [_I] * 7 + [_F] + [_P],
    "sr_mma_msa_attention_smem": [_I] * 2,
    "sr_psa_block": [_I] + [_P] * 8 + [_I] + [_P] + [_I] * 6 + [_F] + [_P],
    "sr_psa_block_smem": [_I] * 3,
    "sr_mma_psa_block": [_P] * 8 + [_I] + [_P] + [_I] * 6 + [_F] + [_P],
    "sr_mma_psa_block_smem": [_I] * 2,
    "sr_scc_block": [_I] + [_P] * 8 + [_I] * 9 + [_P],
    "sr_scc_block_scratch": [_I] * 6,
    "sr_scc_block_smem": [_I] * 6,
    "sr_mma_scc_block": [_P] * 8 + [_I] * 9 + [_P],
    "sr_mma_scc_block_scratch": [_I] * 6,
    "sr_mma_scc_block_smem": [_I] * 5,
    "sr_hab_block": [_I] + [_P] * 16 + [_I] * 7 + [_F] * 3 + [_P],
    "sr_hab_block_smem": [_I] * 4,
    "sr_mma_hab_block": [_P] * 17 + [_I] * 7 + [_F] * 3 + [_P],
    "sr_mma_hab_block_smem": [_I] * 2,
    "sr_hab_front": [_I] + [_P] * 12 + [_I] * 6 + [_F] + [_P],
    "sr_hab_front_smem": [_I] * 3,
    "sr_mma_hab_front": [_P] * 12 + [_I] * 6 + [_F] + [_P],
    "sr_mma_hab_front_smem": [_I] * 2,
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsr_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> tuple[pathlib.Path, str]:
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns (library path, compiler output); verbose adds ptxas's register
    and shared-memory report. Raises RuntimeError when nvcc is missing or
    fails.
    """
    lib = library_path()
    if lib.exists():
        return lib, ""
    nvcc = [_nvcc(), *NVCC_FLAGS]
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    log = []
    try:
        procs = [subprocess.Popen(
            [*nvcc, *(("-Xptxas", "-v") if verbose else ()), "-I",
             str(CSRC_DIR), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        outs = [proc.communicate()[0] for proc in procs]
        log = [f"{src.name}:\n{out}" for src, out in zip(sources, outs)]
        failed = [src.name for src, proc in zip(sources, procs)
                  if proc.returncode]
        if not failed:
            link = subprocess.run([*nvcc, "-shared", "-o", str(tmp),
                                   *map(str, objects)],
                                  capture_output=True, text=True)
            log.append(link.stdout + link.stderr)
            if link.returncode:
                failed = ["link"]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "".join(log)[-12000:])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib, "".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its argtypes set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def use_kernel(x: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor). False: run the plain version
    (CPU tensor). Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no plain path for device {x.device}")


def check_operands(name: str, ref: torch.Tensor, **tensors) -> int:
    """Check that every operand lies on ref's device, has ref's dtype
    (float32 or bfloat16) and is contiguous, and that no gradient is asked
    for (a kernel has no backward; :func:`with_plain_backward` gives one).
    Returns the dtype code."""
    if ref.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported "
                        f"(float32 or bfloat16)")
    for arg, t in tensors.items():
        if t.device != ref.device or t.dtype != ref.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype} on {t.device}, "
                            f"expected {ref.dtype} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name}: the CUDA kernel has no backward")
    return DTYPE_CODES[ref.dtype]


def check_f32(name: str, ref: torch.Tensor, **tensors) -> None:
    """Float32, contiguous, on ref's device: the bias and mask operands."""
    for arg, t in tensors.items():
        if (t.device != ref.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise TypeError(f"{name}: {arg} must be contiguous float32 on "
                            f"{ref.device}, got {t.dtype} on {t.device}")


def check_shape(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def check_smem(name: str, need: int, what: str) -> None:
    """Raise where a block of ``name`` needs more dynamic shared memory
    than the card grants; ``what`` names the shape."""
    if need > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{name}: {what} need {need} bytes of shared "
                         f"memory a block, the card grants "
                         f"{MAX_DYNAMIC_SMEM}")


def stream_of(x: torch.Tensor) -> int:
    """Handle of the current CUDA stream of x's device."""
    return torch.cuda.current_stream(x.device).cuda_stream


def raise_on_error(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{err}")


class _PlainBackward(torch.autograd.Function):
    """Forward: the kernel's wrapper (grad mode is off inside, so it
    launches). Backward: the plain version is run again on the saved
    inputs and differentiated, as JAX's custom_vjp ``*_ad`` functions do;
    only the inputs are saved."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.save_for_backward(*args)
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(outs, wrt, grads, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in need))


def with_plain_backward(kernel, plain, args: tuple, **kw):
    """``kernel(*args, **kw)`` (``args`` tensors only) with a gradient. On
    CUDA tensors that ask for one, the kernel runs forward inside an
    autograd Function whose backward is autograd through ``plain``;
    otherwise (a no-grad forward, or a CPU tensor, whose plain version is
    differentiable already) the wrapper is called as it is, with nothing
    built first."""
    if (torch.is_grad_enabled() and use_kernel(args[0])
            and any(a.requires_grad for a in args)):
        return _PlainBackward.apply(functools.partial(kernel, **kw),
                                    functools.partial(plain, **kw), *args)
    return kernel(*args, **kw)
