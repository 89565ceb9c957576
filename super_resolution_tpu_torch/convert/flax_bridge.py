"""Flax parameters -> the port's state_dict.

The inverse of super_resolution_tpu/convert/torch_import.py (the JAX
package's torch -> flax conversion): its flax module trees mirror the torch
attribute names with sequence indices flattened ('blocks.0' ->
'blocks_0'), so each flax leaf maps to one torch name, and its tensor goes
back through the inverse of ``_transform``. The flax tree is a nested dict
of numpy arrays (``jax.device_get`` of the params), so this module needs no
JAX. The name map is a copy of ``flax_path_to_torch_name``.

The fork HAT's leaves need no rule of their own: the OIHW filters
(``plk_filter``, ``esc_plk``) and the RPB tables keep name and shape, the
ECA ``kernel`` (k, 1, 1) goes back to a Conv1d weight (1, 1, k), the
SplitPointwise and depthwise ``kernel``s (HWIO) to OIHW, and the Dense
``kernel``s of the dynamic-kernel head to 1x1 conv weights. Nor do ESC-FP's
and ESC-Real's: ``lk_channel``, ``lk_spatial`` and ``plk_filter`` keep name
and shape, a numeric child (``skip/0``, ``to_img/8``) keeps its index and a
flattened one (``proj_1``, ``plk/proj_3``) becomes ``proj.1``, the
depthwise 7x7 ``kernel`` goes back to OIHW and the Dense ``kernel``s of
``plk/proj_*`` to 1x1 conv weights.

The video networks need none either: their flax names hold BasicSR's
dotted names (``pcd_align/offset_conv1.l1``, ``spynet/basic_module.0/
basic_module.0``, ``deform_align.backward_1``), which the map keeps; the
DCNs' raw ``weight`` is OIHW already and is copied as it is; the ``mean``
and ``std`` of SpyNet and TOFlow, (1, 1, 1, 3) in flax, are reshaped to
the (1, 3, 1, 1) of BasicSR's; DUF's and TOFlow's frozen batch-norm
statistics, flax parameters, become the port's buffers.

The discriminators' parameters (``params_d``) map the same way, the
VGG-style one's ``bn0_1`` / ``conv0_1`` verbatim (no sequence index); the
spectral-norm state (flax's ``batch_stats``) maps through
:func:`sn_stats_to_state_dict`.

The face networks add two rules. StyleGAN2's leaves need none: their flax
names are BasicSR's dotted ones (``style_mlp.1``, ``activate.bias``,
``constant_input.weight``, ``noises.noise0``), the modulated weights
(1, O, I, k, k) and the equalised ones keep torch's layout, and ToRGB's
bias (1, 1, 1, 3) is reshaped to (1, 3, 1, 1); the spectral-norm convs'
``weight_orig``, ``weight_u`` and ``weight_v`` keep name and shape. But
DFDNet's VGG19 names its convs ``conv1_1`` .. ``conv5_4`` in flax and
``features.N`` in the port (torchvision's names), and a flax module that
its forward never calls has no leaves (HiFaceGAN's ``fc`` and the
``to_rgbs`` before the train phase's): ``flax_to_state_dict(...,
keep=...)`` lets those keep the module's own values.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from super_resolution_tpu_torch.models.vgg_arch import VGG19_LAYERS

_SEQ_IDX = re.compile(r"_(\d+)$")
_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias",
                  "embedding": "weight"}


def flatten_params(tree, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten_params(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def flax_path_to_torch_name(path: tuple) -> str:
    """('layers_0','residual_group','blocks_1','mlp','fc1','kernel')
    -> 'layers.0.residual_group.blocks.1.mlp.fc1.weight'."""
    comps = [_SEQ_IDX.sub(r".\1", comp) for comp in path[:-1]]
    comps.append(_LEAF_TO_TORCH.get(path[-1], path[-1]))
    return ".".join(comps)


def _untransform(leaf: str, src: np.ndarray, target_shape: tuple) -> np.ndarray:
    """Inverse of torch_import._transform: flax leaf -> torch tensor."""
    src = np.asarray(src)
    if leaf == "kernel":
        if src.ndim == 5 and len(target_shape) == 5:
            return src.transpose(4, 3, 0, 1, 2)     # DHWIO -> OIDHW
        if src.ndim == 4 and len(target_shape) == 4:
            return src.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        if src.ndim == 2 and len(target_shape) == 4:
            return src.T[:, :, None, None]          # Dense -> 1x1 conv
        if src.ndim == 2 and len(target_shape) == 2:
            return src.T
        if src.ndim == 3 and len(target_shape) == 3:
            return src.transpose(2, 1, 0)           # WIO -> OIW
        if len(target_shape) == 1:
            return src.reshape(-1)
        raise ValueError(f"No kernel transform {src.shape} -> {target_shape}")
    if src.shape != tuple(target_shape):
        return src.reshape(target_shape)
    return src


def flax_torch_names(flax_params: dict,
                     module: torch.nn.Module) -> Dict[tuple, str]:
    """{flax leaf path: the name of the tensor of ``module`` it maps to}.
    A flax name may hold dots of its own (EDVR's ``offset_conv1.l1``,
    SpyNet's ``basic_module.0``, BasicVSR++'s ``deform_align.backward_1``):
    the map keeps them."""
    target = module.state_dict()
    names = {}
    for path in flatten_params(flax_params):
        modules = [_SEQ_IDX.sub(r".\1", c) for c in path[:-1]]
        # a parameter of the module's own can bear a leaf name that the map
        # rewrites (ATD_CA's ``scale`` is no LayerNorm weight), and a module
        # name can end in a number that is no sequence index (the VGG-style
        # discriminator's ``bn0_1``, BasicVSR++'s ``backward_1``)
        leaf = _LEAF_TO_TORCH.get(path[-1], path[-1])
        candidates = (flax_path_to_torch_name(path),
                      ".".join(modules + [path[-1]]),
                      ".".join([*path[:-1], leaf]),
                      # a VGG19 conv by basicsr's layer name
                      ".".join([f"features.{VGG19_LAYERS.index(c)}"
                                if c in VGG19_LAYERS else c
                                for c in path[:-1]] + [leaf]))
        name = next((c for c in candidates if c in target), candidates[0])
        if name not in target:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: no such "
                           f"tensor in {type(module).__name__}")
        names[path] = name
    return names


def flax_to_state_dict(flax_params: dict, module: torch.nn.Module,
                       keep=()) -> Dict[str, torch.Tensor]:
    """A full state_dict for ``module`` from a flax param tree.

    Every flax leaf must name a tensor of ``module`` and every parameter
    must be covered; buffers the tree lacks (index tables) keep the
    module's own values, those it has (frozen batch norms' statistics) take
    the tree's. A parameter whose name starts with an entry of ``keep``
    may lack a leaf and keeps the module's value. The result loads with
    ``module.load_state_dict(sd, strict=True)``.
    """
    target = module.state_dict()
    params = {name for name, _ in module.named_parameters()}
    names = flax_torch_names(flax_params, module)
    out = {}
    for path, value in flatten_params(flax_params).items():
        name = names[path]
        arr = _untransform(path[-1], value, tuple(target[name].shape))
        out[name] = torch.from_numpy(np.array(arr)).to(
            target[name].dtype)
    missing = sorted(p for p in params - set(out)
                     if not p.startswith(tuple(keep)))
    if missing:
        raise KeyError(f"parameters without a flax leaf: {missing[:10]}")
    for name, t in target.items():
        out.setdefault(name, t.detach().clone())
    return out


def sn_stats_to_state_dict(sn_stats: dict,
                           prefix: str = "") -> Dict[str, torch.Tensor]:
    """flax ``SpectralNorm``'s state, {'SpectralNorm_i': {'conv1/kernel/u':
    (1, out), 'conv1/kernel/sigma': ()}}, as the port's buffers
    {'conv1.weight_u': (out,), 'conv1.weight_sigma': ()}; a submodule's
    state ({'sa2': {'SpectralNorm_0': {'to_out/kernel/u': ...}}}) under its
    name ('sa2.to_out.weight_u')."""
    out = {}
    for key, group in sn_stats.items():
        if not key.startswith("SpectralNorm"):
            out.update(sn_stats_to_state_dict(group, f"{prefix}{key}."))
            continue
        for path, value in group.items():
            layer, leaf, stat = path.split("/")
            arr = np.array(value, dtype=np.float32)
            name = f"{prefix}{layer}.{_LEAF_TO_TORCH[leaf]}_{stat}"
            out[name] = torch.from_numpy(arr.reshape(-1) if stat == "u"
                                         else arr)
    return out
