"""State introspection and checkpoint/resume: the port of utils/state.py.

The reference's only introspection hook is the ``IStateDumper`` visitor
(reference: src/main/iface/IStateDumper.cpp).  Here every processor's
state is an explicit tree of NamedTuples, tuples, lists and dicts
(utils/tree.py), so checkpoint/resume is structural:

* :func:`dump_state`: tree -> {path: numpy array};
* :func:`save_state` / :func:`load_state`: an npz round trip keyed by the
  same paths, restored into the structure of a given state;
* :class:`StateDumper`: a visitor-style text formatter with the
  reference's ``write/begin_object/end_object`` surface.

The paths are the JAX package's (``fdl/spec_re``, ``env/hold``), and
``None`` leaves are skipped as ``jax.tree_util`` skips them: a checkpoint
the JAX package saved loads into the port's state of the same structure,
and the other way round.
"""

from __future__ import annotations

import io
import os
import warnings
from typing import Any, Dict

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.utils.tree import leaves_with_path, tree_map


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def dump_state(tree: Any) -> Dict[str, np.ndarray]:
    """Flatten a state tree into {path: numpy array}."""
    return {path: _host(leaf) for path, leaf in leaves_with_path(tree)}


def save_state(path: str, tree: Any) -> None:
    np.savez(path, **dump_state(tree))


def _like(arr: np.ndarray, leaf):
    """``arr`` as the kind of ``leaf``: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python number."""
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr)).to(dtype=leaf.dtype,
                                                  device=leaf.device)
    if isinstance(leaf, np.ndarray):
        return np.asarray(arr, leaf.dtype)
    return type(leaf)(arr.item()) if isinstance(leaf, (bool, int, float)) \
        else arr


def load_state(path: str, like: Any) -> Any:
    """Load a checkpoint into the structure of ``like``."""
    # np.savez appends '.npz' to a path without it; mirror that so
    # save_state('ckpt') / load_state('ckpt') round-trips
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        keys = set(data.files)
        wanted = [p for p, _ in leaves_with_path(like)]
        missing = [p for p in wanted if p not in keys]
        if missing:
            raise KeyError(f"checkpoint missing state leaf: {missing[0]}")
        arrays = {p: data[p] for p in wanted}
    unused = keys - set(wanted)
    if unused:
        warnings.warn(f"checkpoint keys unused by this state structure: "
                      f"{sorted(unused)}", stacklevel=2)
    it = iter(wanted)
    return tree_map(lambda leaf: _like(arrays[next(it)], leaf), like)


class StateDumper:
    """Visitor-style text dump (reference IStateDumper surface)."""

    def __init__(self):
        self._buf = io.StringIO()
        self._indent = 0

    def _line(self, s: str) -> None:
        self._buf.write("  " * self._indent + s + "\n")

    def write(self, name: str, value) -> None:
        v = _host(value)
        if v.ndim == 0:
            self._line(f"{name} = {v}")
        else:
            self._line(f"{name} = array{v.shape} {v.dtype} "
                       f"[{np.min(v):.6g}..{np.max(v):.6g}]")

    def begin_object(self, name: str) -> None:
        self._line(f"{name} = {{")
        self._indent += 1

    def end_object(self) -> None:
        self._indent -= 1
        self._line("}")

    def write_tree(self, name: str, tree) -> None:
        self.begin_object(name)
        for k, v in dump_state(tree).items():
            self.write(k, v)
        self.end_object()

    def text(self) -> str:
        return self._buf.getvalue()
