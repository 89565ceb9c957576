"""Parallelism: the device mesh and its collectives (``mesh``), tensor
parallelism over the heads and the MLP hidden dim (``tp``,
``tp_attention``, ``tp_ffn``), GPipe over the residual groups
(``pipeline``) and row-sharded inference (``spatial``). Port of
super_resolution_tpu/parallel/.

JAX runs one process over many devices; PyTorch runs one process a device
(``torchrun --nproc_per_node N``). A JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names
(``data``, ``model``, ``pipe``), and a ``psum`` / ``ppermute`` over an axis
a collective over ``mesh.get_group(axis)``.
"""
