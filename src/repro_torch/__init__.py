"""PyTorch/CUDA port of the SIMD-ified R-tree query engine.

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``distributed/``, ``runtime/``, ``launch/``) so every module's counterpart
is easy to find.  Plain tensor code is PyTorch; the kernels of the main
path are CUDA C++ written for Hopper (``kernels/csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
