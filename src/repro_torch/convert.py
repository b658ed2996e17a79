"""Parameter trees from the reference package's layout.

``params_from_numpy(tree, device)`` maps a parameter tree with the
reference ``repro.models.init_params`` layout — nested dicts, per-layer
weights stacked on a leading ``layers`` axis, leaves as numpy arrays —
onto torch tensors with the same keys and shapes, so both packages
compute the same model. The caller does the ``numpy`` conversion
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the same tree of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
