"""The PyTorch/CUDA port of the copy-detection system, for one NVIDIA H100.

It mirrors the JAX package ``repro`` module for module and imports neither
JAX nor ``repro``. Entry points run on the card unless the caller passes
``device="cpu"``; on the card the tiled scan runs a hand-written Hopper
kernel (``kernels/csrc``), on the CPU its plain PyTorch version.
"""
