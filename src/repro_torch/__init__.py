"""The PyTorch/CUDA port of the copy-detection system, for one NVIDIA H100.

It mirrors the JAX package ``repro`` module for module and imports neither
JAX nor ``repro``. Entry points run on the card unless the caller passes
``device="cpu"``. On the card the detection pass's tiled scan and the LM
prefill's attention run hand-written Hopper kernels (``kernels/csrc``); on
the CPU they run the kernels' plain PyTorch versions.
"""
