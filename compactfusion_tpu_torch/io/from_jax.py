"""Carry parameters from the JAX package into the port.

``params_from_numpy`` takes the JAX package's parameter tree with numpy
leaves (``jax.tree_util.tree_map(np.asarray, params)``) and returns the same
tree of torch tensors: dicts stay dicts (the stacked leading layer axis of
``init_pixart``, ``init_flux``, ``init_cogvideox`` and ``init_stepvideo``
included, Step-Video's head-axis projections in their (d, n, H, hd) and
(H, hd, d) layouts), lists stay
lists (the up blocks and their resnets of the 2D and the 3D VAE).  This
module imports neither jax nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects the ml_dtypes bfloat16 dtype: reinterpret
        # the bits as uint16 and view them back as torch.bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cpu", dtype=None):
    """Numpy (or array-like) parameter tree -> torch tree on ``device``.
    ``dtype`` casts floating-point leaves when given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    return _to_tensor(tree, device, dtype)
