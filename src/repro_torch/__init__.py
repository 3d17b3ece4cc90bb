"""PyTorch/CUDA port of Ferret (the JAX package ``repro`` is the reference).

The port mirrors ``repro``'s subpackage layout so each module has one
counterpart there. It imports ``torch`` and ``numpy`` and nothing of
``repro`` or JAX. Entry points run on the CUDA card unless the caller asks
for the CPU; on the card the Iter-Fisher hot loops are hand-written CUDA
kernels (``repro_torch/csrc``), on the CPU their plain PyTorch versions.
"""
