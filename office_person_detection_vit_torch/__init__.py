"""PyTorch/CUDA port of ``office_person_detection_vit_tpu`` for one NVIDIA H100.

Subpackages mirror the JAX package's layout (``core``, ``ops``, ``models``,
``detection``); the hand-written CUDA kernels live in ``csrc`` and their
wrappers in ``kernels``. The package imports torch, numpy and the standard
library only: nothing of JAX and nothing of the JAX package.
"""
