"""PyTorch/CUDA port of the SIMD-ified R-tree query engine.

Mirrors the layout of the JAX package (``core/``, ``kernels/``,
``distributed/``, ``runtime/``, ``launch/``) so every module's counterpart
is easy to find.  Plain tensor code is PyTorch; the kernels of the main
path are CUDA C++ written for Hopper (``kernels/csrc``), built with
``nvcc`` at first use and bound with ``ctypes``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""


def resolve_device(name: str):
    """``name`` ('cuda' or 'cpu') as a ``torch.device``.  'cuda' raises
    where CUDA is not available: a caller that asked for the card never
    runs on the CPU unawares."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    return torch.device(name)
