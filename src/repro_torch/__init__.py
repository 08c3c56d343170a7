"""PyTorch/CUDA port of ES-dLLM offline generation.

Mirrors the layout of the JAX reference package ``repro``: ``configs``,
``models``, ``kernels`` (hand-written Hopper kernels beside their plain
PyTorch versions) and ``core`` (the diffusion engine).  It imports neither
JAX nor the reference package; ``convert.params_from_numpy`` takes the
reference's parameter tree as numpy arrays.
"""
