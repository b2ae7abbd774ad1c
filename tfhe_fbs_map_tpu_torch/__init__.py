"""TFHE functional bootstrapping on PyTorch and CUDA (NVIDIA Hopper).

A port of :mod:`tfhe_fbs_map_tpu` beside it: the same keys, ciphertexts and
bootstrap results bit for bit, with the fused blind rotation as CUDA
kernels for ``sm_90a`` (:mod:`.ops.fused_blind_rotate`).  It imports torch
and numpy, and from the JAX package only the framework-free frontend
(parsers, IR, mappers).
"""
