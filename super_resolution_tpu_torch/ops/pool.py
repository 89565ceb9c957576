"""Average pooling of the NCHW views the port's networks take of NHWC
activations.

On the card, PyTorch's backward of a padded ``F.avg_pool2d`` gives wrong
input gradients on a channels_last tensor (the layout of ``x.permute(0, 3,
1, 2)`` of an NHWC activation, and of a conv's output on one), with either
``count_include_pad``; its forward, and the CPU's backward, are right
(torch 2.11.0+cu128 on an H100; ``tests/test_torch_face_cuda.py``).
:func:`avg_pool2d` pools a contiguous copy where the call pads: the
layers that train through a padded pool (EDVR's pyramid, HiFaceGAN's LIP
and its discriminator's scales) call it.
"""

from __future__ import annotations

import torch.nn.functional as F


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               count_include_pad: bool = True):
    """``F.avg_pool2d``, on ``x.contiguous()`` where ``padding`` is set."""
    if padding:
        x = x.contiguous()
    return F.avg_pool2d(x, kernel_size, stride, padding,
                        count_include_pad=count_include_pad)
