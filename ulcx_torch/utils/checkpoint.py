"""Codec state checkpoint/resume.

Port of ``ulcx.utils.checkpoint`` with ulcx's file layout, so that each
package loads the other's checkpoints. The codec state is its carry
(SURVEY.md §5): the encoder's sample/lap/transient state (reference
include/ulcEncoder.h:64-77) and the decoder's inverse lap and RNG
(include/ulcDecoder.h:27-31). A carry is a NamedTuple of tensors, possibly
nested (``EncoderCarry`` holds a ``TransientState``), batched or not.

The ``.npz`` holds ``leaf_0`` .. ``leaf_{n-1}`` in ulcx's flatten order
(fields in order, depth first) and ``__treedef__``, the string JAX prints
for the same structure, e.g.
``PyTreeDef(CustomNode(namedtuple[DecoderCarry], [*, *, *]))``. The
decoder's RNG state travels in the port as int32 holding the u32 bits;
on disk it is u32, as in ulcx.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(carry, name=None) -> list:
    """[(field name, tensor)] of the carry in ulcx's flatten order."""
    if isinstance(carry, torch.Tensor):
        return [(name, carry)]
    return [leaf for field, value in zip(carry._fields, carry) for leaf in _leaves(value, field)]


def _node(carry) -> str:
    if isinstance(carry, torch.Tensor):
        return "*"
    kids = ", ".join(_node(field) for field in carry)
    return f"CustomNode(namedtuple[{type(carry).__name__}], [{kids}])"


def treedef(carry) -> str:
    """The structure string JAX's ``tree_flatten`` gives ulcx's carry of
    the same type."""
    return f"PyTreeDef({_node(carry)})"


def _rebuild(like, leaves):
    """``like``'s structure with ``leaves`` (an iterator) in its places."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    return type(like)(*(_rebuild(field, leaves) for field in like))


def save_carry(path: str, carry) -> None:
    """Save a codec carry (EncoderCarry or DecoderCarry, single or
    batched) to ``path`` as ulcx's ``save_carry`` does."""
    leaves = []
    for name, x in _leaves(carry):
        arr = x.detach().cpu().numpy()
        leaves.append(arr.view(np.uint32) if name == "rng" else arr)
    np.savez(
        path,
        __treedef__=np.frombuffer(treedef(carry).encode(), dtype=np.uint8),
        **{f"leaf_{i}": x for i, x in enumerate(leaves)},
    )


def load_carry(path: str, like):
    """Load a carry saved by either package's ``save_carry``. ``like``, a
    carry of the port of the same kind and shape (``EncoderCarry.init(cfg,
    B, device)``, or a stream's carry as ``encode_stream`` returns it),
    gives the structure, dtypes, shapes and device. A structure,
    leaf-count or shape mismatch raises with ulcx's messages rather than
    reinterpreting leaves."""
    refs = [x for _, x in _leaves(like)]
    want_def = treedef(like)
    with np.load(path) as data:
        stored_def = bytes(data["__treedef__"]).decode()
        if stored_def != want_def:
            raise ValueError(
                "checkpoint pytree structure mismatch:\n"
                f"  stored:   {stored_def}\n  expected: {want_def}"
            )
        n_stored = sum(1 for k in data.files if k.startswith("leaf_"))
        if n_stored != len(refs):
            raise ValueError(f"checkpoint has {n_stored} leaves, expected {len(refs)}")
        arrs = [data[f"leaf_{i}"] for i in range(len(refs))]
    loaded = []
    for i, (arr, ref) in enumerate(zip(arrs, refs)):
        if arr.shape != tuple(ref.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ref.shape)}"
            )
        if arr.dtype == np.uint32 and ref.dtype == torch.int32:
            arr = arr.view(np.int32)  # the RNG state's bits
        loaded.append(torch.from_numpy(np.array(arr)).to(ref.device, ref.dtype))
    return _rebuild(like, iter(loaded))
