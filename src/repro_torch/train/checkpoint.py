"""Checkpoint pool: per-adapter save/load (npz) and resumable packed state
(the port of ``repro/train/checkpoint.py``).

At the end of a packed fine-tuning job the execution engine extracts each
adapter from the pack and stores it here. The file format is the
reference's: one ``.npz`` per tree, keys are the tree's ``/``-joined paths,
plus an optional ``.json`` meta beside it, so a file written by either
package loads in the other. Leaves may be torch tensors or numpy arrays;
``load_tree`` returns numpy arrays on the host.

bf16 leaves are stored as numpy writes an ``ml_dtypes.bfloat16`` array: two
raw bytes (``|V2``), since the npz format has no name for bf16. The port
writes a torch bf16 tensor as those same bytes and reads ``|V2`` back as
``ml_dtypes.bfloat16`` (imported only when such a leaf is read).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf_to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # the bytes numpy writes for ml_dtypes bf16
            return t.view(torch.uint16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _leaf_from_file(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.dtype("V2"):
        import ml_dtypes  # only for bf16 leaves

        return a.view(ml_dtypes.bfloat16)
    return a


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _leaf_to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _leaf_from_file(v)
    return tree


def save_tree(path: str, tree, meta: Optional[dict] = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=2)


def load_tree(path: str):
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


class CheckpointPool:
    """Directory of fine-tuned adapters keyed by adapter id."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, adapter_id: str) -> str:
        return os.path.join(self.root, f"{adapter_id}.npz")

    def save_adapter(self, adapter_id: str, adapter_tree, config_meta: dict):
        save_tree(self._path(adapter_id), adapter_tree, config_meta)

    def load_adapter(self, adapter_id: str):
        return load_tree(self._path(adapter_id))

    def load_meta(self, adapter_id: str) -> dict:
        with open(self._path(adapter_id) + ".json") as f:
            return json.load(f)

    def has(self, adapter_id: str) -> bool:
        return os.path.exists(self._path(adapter_id))

    # "state_" / "part_" are reserved prefixes: whole-pack snapshots and
    # preempted-adapter training state live in the same directory but are
    # not finished adapters, so list() (whose callers read final_loss meta)
    # does not return them.
    _RESERVED = ("state_", "part_")

    def list(self):
        return sorted(
            f[:-4]
            for f in os.listdir(self.root)
            if f.endswith(".npz") and not f.startswith(self._RESERVED)
        )

    def list_states(self):
        """Ids of resumable snapshots: packed states and per-adapter
        preempted-training state (the reserved-prefix files)."""
        return sorted(
            f[:-4]
            for f in os.listdir(self.root)
            if f.endswith(".npz") and f.startswith(self._RESERVED)
        )

    # Two granularities of resumable state:
    #   * whole-pack snapshots, to resume the same job after an interruption
    #     (launch/train.py --save-state/--resume-state);
    #   * per-adapter training state (weights + Adam moments + step count),
    #     which a preempted job checkpoints for each unfinished adapter and
    #     the engine injects into whatever pack it lands in next.

    def save_packed_state(self, state_id: str, lora, opt_state, meta: dict):
        save_tree(self._path(f"state_{state_id}"), {"lora": lora, "opt": opt_state}, meta)

    def load_packed_state(self, state_id: str):
        tree = load_tree(self._path(f"state_{state_id}"))
        meta = self.load_meta(f"state_{state_id}")
        return tree["lora"], tree["opt"], meta

    def save_adapter_state(self, adapter_id: str, state_tree, meta: dict):
        """``state_tree`` = {"w": adapter, "m": moments, "v": moments}."""
        save_tree(self._path(f"part_{adapter_id}"), state_tree, meta)

    def load_adapter_state(self, adapter_id: str):
        tree = load_tree(self._path(f"part_{adapter_id}"))
        return tree, self.load_meta(f"part_{adapter_id}")

    def has_adapter_state(self, adapter_id: str) -> bool:
        return self.has(f"part_{adapter_id}")
