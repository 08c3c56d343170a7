"""PyTorch/CUDA port of ES-dLLM: offline generation and paged serving.

Mirrors the layout of the JAX reference package ``repro``: ``configs``,
``models``, ``kernels`` (hand-written Hopper kernels beside their plain
PyTorch versions), ``core`` (the diffusion engine and its serving step),
``runtime`` (the continuous-batching scheduler) and ``launch`` (the serving
entry point).  It imports neither JAX nor the reference package;
``convert.params_from_numpy`` takes the reference's parameter tree as numpy
arrays.
"""
