"""numpy ↔ torch conversion of parameter trees.

The JAX package and the port share one parameter layout (nested dicts,
blocks stacked over layers), so weights cross between them as a nested
dict of numpy arrays: ``params_from_numpy`` makes the port's tensors from
it, ``to_numpy`` goes back. bfloat16 has no numpy dtype of its own: such
arrays (``ml_dtypes.bfloat16``, what JAX hands out) become bfloat16
tensors, and bfloat16 tensors come back as float32 arrays.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)  # a copy: JAX hands out read-only arrays


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict of numpy arrays → the same keys, shapes and dtypes as
    tensors on ``device``."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def to_numpy(tree: Any) -> Any:
    """Tree of tensors → tree of numpy arrays on the host."""
    return tree_map(_to_array, tree)
