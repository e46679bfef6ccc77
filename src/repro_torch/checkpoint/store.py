"""Fault-tolerant checkpointing: atomic commit, retention, async writer
(the port of ``repro.checkpoint.store``; the on-disk format is the
reference's, so a checkpoint written by either package restores in the
other).

Layout::

    <dir>/step_000000123/
        manifest.json          {"step": 123, "leaves": [...], "complete": true}
        arr_00000.npy ...      one file per tree leaf, in flattening order

Flattening follows the reference's tree order: dict keys sorted, lists
and tuples in order, ``None`` holds no leaf.  Tensors are written through
``.detach().cpu().numpy()``, except bfloat16 ones, which numpy has no
type for: their raw 16 bits are written as the reference writes a
bfloat16 leaf, an ``.npy`` whose descr is ``<V2``, and read back bit for
bit into a bfloat16 tensor (a ``V2`` file holds bfloat16 bits here, the
reference's or the port's; ``ml_dtypes`` is not needed).

Atomicity: write into ``step_X.tmp`` then ``os.replace`` to ``step_X``; a
crash mid-write leaves only a tmp dir that restore ignores and the next
save overwrites.  ``CheckpointManager`` adds retention (keep last N), an
async background writer thread (the caller never blocks on disk), and
auto-resume.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
    "list_steps",
    "CheckpointManager",
]


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:09d}")


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """Leaves in the reference's order and a printable structure string
    (the manifest's ``treedef``; no loader reads it)."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in keys) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(tree_like: Any, leaves: List[Any]) -> Any:
    """``tree_like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(tree_like)


# the descr of a bfloat16 leaf in the reference's files (ml_dtypes'
# bfloat16 has no numpy type code: numpy writes it as 2-byte void)
_BF16_DESCR = "<V2"


def _to_host(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf``: never the live tensor or array, which the
    caller may change in place (an optimizer step) while an asynchronous
    writer still holds the snapshot."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().to("cpu", copy=True)
        if leaf.dtype == torch.bfloat16:  # its bits, as 2-byte void
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.array(leaf)


def _save_npy(path: str, arr: np.ndarray) -> None:
    if arr.dtype != np.dtype("V2"):
        np.save(path, arr)
        return
    # np.save would write descr "|V2": write the reference's "<V2" header
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):  # bfloat16 bits
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, _ = _flatten(tree)
    return _unflatten(tree, [fn(leaf) for leaf in leaves])


def save_checkpoint(root: str, step: int, tree: Any,
                    extra: Optional[Dict] = None) -> str:
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = _flatten(tree)
    paths = []
    for i, leaf in enumerate(leaves):
        p = f"arr_{i:05d}.npy"
        _save_npy(os.path.join(tmp, p), _to_host(leaf))
        paths.append(p)
    manifest = {
        "step": step,
        "leaves": paths,
        "treedef": treedef,
        "extra": extra or {},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(root: str) -> list:
    """All *complete* checkpoint steps under ``root``, ascending.

    Torn writes (missing/incomplete manifest, unparsable JSON) are
    skipped — they never surface as restorable steps.
    """
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            mf = os.path.join(root, name, "manifest.json")
            if os.path.exists(mf):
                try:
                    with open(mf) as f:
                        m = json.load(f)
                    if m.get("complete"):
                        steps.append(int(m["step"]))
                except Exception:
                    continue
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


def load_checkpoint(root: str, tree_like: Any,
                    step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``tree_like``: a tensor leaf comes
    back as a tensor of its dtype on its device (a stored bfloat16 leaf
    bit for bit), any other leaf as the stored numpy array."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, _ = _flatten(tree_like)
    assert len(leaves_like) == len(manifest["leaves"]), (
        "checkpoint/tree structure mismatch"
    )
    new_leaves = []
    for leaf, p in zip(leaves_like, manifest["leaves"]):
        arr = np.load(os.path.join(d, p))
        new_leaves.append(_from_host(arr, leaf) if torch.is_tensor(leaf)
                          else arr)
    return (
        _unflatten(tree_like, new_leaves),
        step,
        manifest.get("extra", {}),
    )


class CheckpointManager:
    """Async writer + retention + auto-resume."""

    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree, extra = item
            try:
                save_checkpoint(self.root, step, host_tree, extra)
                self._retain()
            except BaseException as e:  # surfaced on next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def _retain(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        if self._error:
            raise self._error
        # device->host copy happens here (synchronous, cheap vs disk IO)
        host_tree = _map_leaves(_to_host, tree)
        if self.async_write:
            self._q.put((step, host_tree, extra))
        else:
            save_checkpoint(self.root, step, host_tree, extra)
            self._retain()

    def restore_or_none(self, tree_like: Any):
        step = latest_step(self.root)
        if step is None:
            return None
        return load_checkpoint(self.root, tree_like, step)

    def wait(self):
        """Drain pending writes (call before exit / in tests)."""
        if self._thread is not None:
            self._q.join()
        if self._error:
            raise self._error

    def close(self):
        if self._thread is not None:
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=5)
            self._thread = None
