"""TFHE functional bootstrapping on PyTorch and CUDA (NVIDIA Hopper).

A port of :mod:`tfhe_fbs_map_tpu` beside it: the same keys, ciphertexts and
bootstrap results bit for bit, with the fused blind rotation as CUDA
kernels for ``sm_90a`` (:mod:`.ops.fused_blind_rotate`).  It imports torch
and numpy and nothing of the JAX package: what it needs of the JAX
package's framework-free frontend (parsers, IR, mappers) it carries as its
own copy, :mod:`.frontend`.
"""
