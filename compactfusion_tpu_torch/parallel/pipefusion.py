"""Synchronous PipeFusion: the transformer blocks split into pipeline stages
(counterpart of ``compactfusion_tpu/parallel/pipefusion.py``).

Reference: ``_split_transformer_blocks`` slices the block list over the pp
ranks and the activations hop stage to stage (``PipelineGroupCoordinator``).
The JAX package runs every stage's blocks in every round and masks all but
the active stage's result, so that one SPMD program serves every device;
here each rank runs its own control flow: stage s receives the
activations from stage s - 1, runs its local blocks (``parallel/tp.py``
cut them; only their attention and EF state advance), sends the result to
stage s + 1, and the last stage's result is broadcast to every stage.
Every hop and the broadcast are exact copies, so a stage runs the kernels
of one process on the shapes of one process: the pipeline equals one
process bit for bit.  Stages wait on their inbound hop, not on each other's
compute, so per-stage collectives (ring, Ulysses, TP) stay within a stage.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from compactfusion_tpu_torch.parallel.mesh import AXIS_PP, Mesh


def pipefusion_blocks(run_local: Callable[[Any], Any], h: Any, mesh: Optional[Mesh],
                      axis: str = AXIS_PP) -> Any:
    """Run the pipeline of local block stacks over ``axis`` of ``mesh``.

    ``run_local(h) -> h`` applies this rank's local blocks (their strategies
    update their state in place).  ``h``, a tensor or a tuple of them (the
    (image, text) pair of the joint-attention models), enters identical on
    every stage and serves as the shape of the hops.  Returns the
    full-depth result on every stage."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    if n == 1:
        return run_local(h)
    s = mesh.axis_index(axis)
    if s > 0:
        h = mesh.recv_tree(h, axis, s - 1)
    h = run_local(h)
    if s < n - 1:
        mesh.send_tree(h, axis, s + 1)
    return mesh.broadcast_tree(h, axis, n - 1)


def mirror_exchange(tree: Any, mesh: Optional[Mesh], axis: str = AXIS_PP) -> Any:
    """Swap a tensor tree with the mirror stage over ``axis``: stage s gets
    stage P-1-s's tree (HunyuanDiT's skip channel; the JAX package's
    ``ppermute`` with the mirror permutation).  Of each pair the lower stage
    sends first and the higher one receives first, so the two never wait
    on each other; a middle stage (odd P) keeps its own tree."""
    n = 1 if mesh is None else mesh.axis_size(axis)
    s = 0 if mesh is None else mesh.axis_index(axis)
    m = n - 1 - s
    if m == s:
        return tree
    if s < m:
        mesh.send_tree(tree, axis, m)
        return mesh.recv_tree(tree, axis, m)
    got = mesh.recv_tree(tree, axis, m)
    mesh.send_tree(tree, axis, m)
    return got
