"""Tensor parallelism and PipeFusion stage slicing of a parameter tree
(counterpart of ``compactfusion_tpu/parallel/tp.py``).

The JAX package builds a ``PartitionSpec`` tree and lets ``shard_map``
hand every device its shard; here :func:`local_params` cuts this rank's
part out of the full tree:

- every feed-forward subtree (``FFN_KEYS``: ``{fc1: {w, b}, fc2: {w, b}}``)
  is split Megatron-style over the tp axis: fc1 by columns (the hidden
  axis of its weight and bias), fc2 by rows; fc2's bias stays whole, since
  ``models/common.ffn`` adds it after the all-reduce (reference
  ``xFuserFeedForwardWrapper``, ``layers/feedforward.py:15-69``);
- every block stack at the top of the tree (``BLOCK_KEYS``) keeps this pp
  stage's ``depth / pp`` layers of its leading layer axis (reference
  ``_split_transformer_blocks``).  A nested stack that reuses a name
  (HunyuanVideo's ``refiner.blocks``) is no stage and stays whole;
- Step-Video's attention projections (``heads=STEPVIDEO_HEADS``, the JAX
  ``stepvideo_param_specs``) split on their head axis: the column-parallel
  ``qkv``, ``cross_q`` and ``cross_kv`` (w ``(.., d, n, H, hd)``, b ``(..,
  n, H, hd)``) and the row-parallel ``attn_out`` and ``cross_out`` (w
  ``(.., H, hd, d)``; their bias stays whole, added after the all-reduce).
  Every other family passes no ``heads`` and slices as before.

Sliced leaves are copies, so the caller may free the full tree; leaves that
are not sliced are the caller's tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from compactfusion_tpu_torch.parallel.mesh import AXIS_PP, AXIS_TP, Mesh

#: parameter-subtree names of the feed-forwards that TP splits
FFN_KEYS = ("ffn", "img_ffn", "txt_ffn", "mlp")

#: top-level parameter-subtree names whose leading (layer) axis splits over pp
BLOCK_KEYS = ("blocks", "double_blocks", "single_blocks", "down_blocks", "up_blocks")

#: Step-Video's head-parallel projections: "column" splits w's and b's head
#: axis (the second to last of ``(.., d, n, H, hd)`` and ``(.., n, H,
#: hd)``), "row" w's (the third to last of ``(.., H, hd, d)``)
STEPVIDEO_HEADS = {"qkv": "column", "cross_q": "column", "cross_kv": "column", "attn_out": "row",
                   "cross_out": "row"}


def _part(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % parts:
        raise ValueError(f"axis {dim} of {tuple(t.shape)} does not split into {parts}")
    return t.narrow(dim, index * (n // parts), n // parts).clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, *, tp_index: int = 0, tp_size: int = 1, pp_index: int = 0,
                 pp_size: int = 1, heads: Optional[Dict[str, str]] = None) -> Any:
    """The part of ``params`` that the rank at (``tp_index``, ``pp_index``)
    holds: feed-forwards split over ``tp_size`` ranks, top-level block
    stacks over ``pp_size`` stages (the JAX ``model_param_specs(tp=, pp=)``
    applied to one rank), and the block subtrees named in ``heads`` split on
    their head axis (:data:`STEPVIDEO_HEADS`)."""

    def stage(t):
        return _part(t, 0, pp_index, pp_size) if pp_size > 1 else t

    def ffn(sub, in_block):
        out = {}
        for name, lin in sub.items():
            out[name] = {}
            for k, t in lin.items():
                if name == "fc1":
                    t = _part(t, t.dim() - 1, tp_index, tp_size)
                elif k == "w":  # fc2's weight by rows; its bias stays whole
                    t = _part(t, t.dim() - 2, tp_index, tp_size)
                out[name][k] = stage(t) if in_block else t
        return out

    def head_split(sub, kind):
        out = {}
        for k, t in sub.items():
            if kind == "column":
                t = _part(t, t.dim() - 2, tp_index, tp_size)
            elif k == "w":  # row-parallel: the bias stays whole
                t = _part(t, t.dim() - 3, tp_index, tp_size)
            out[k] = stage(t)
        return out

    def walk(node, in_block, top):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if tp_size > 1 and k in FFN_KEYS and isinstance(v, dict) and "fc1" in v:
                    out[k] = ffn(v, in_block)
                elif tp_size > 1 and in_block and heads and k in heads:
                    out[k] = head_split(v, heads[k])
                else:
                    out[k] = walk(v, in_block or (top and k in BLOCK_KEYS), False)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_block, False) for v in node)
        return stage(node) if in_block and isinstance(node, torch.Tensor) else node

    return walk(params, False, True)


def local_params(params: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's part of the full tree ``params`` on ``mesh`` (the tree
    itself without a mesh or where tp and pp are 1)."""
    if mesh is None or (mesh.axis_size(AXIS_TP) == 1 and mesh.axis_size(AXIS_PP) == 1):
        return params
    return shard_params(params, tp_index=mesh.axis_index(AXIS_TP), tp_size=mesh.axis_size(AXIS_TP),
                        pp_index=mesh.axis_index(AXIS_PP), pp_size=mesh.axis_size(AXIS_PP))


def stepvideo_local_params(params: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's part of a Step-Video tree: the heads of every attention
    projection and the ffn split over tp, as the JAX ``stepvideo_param_specs``
    shards them.  Step-Video has no pipeline stages: its pp ranks each hold
    every layer, as the JAX specs replicate the blocks over pp."""
    if mesh is None or mesh.axis_size(AXIS_TP) == 1:
        return params
    return shard_params(params, tp_index=mesh.axis_index(AXIS_TP), tp_size=mesh.axis_size(AXIS_TP),
                        heads=STEPVIDEO_HEADS)
