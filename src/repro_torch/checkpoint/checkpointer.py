"""Atomic, async checkpoints in the reference's on-disk format
(``repro.checkpoint.checkpointer``).

Layout, byte for byte the reference's::

    <dir>/step_<n>/manifest.json   {step, leaves: [{key, file, shape, dtype}], complete}
    <dir>/step_<n>/leaf_00000.npy ...

Writes go to ``step_<n>.tmp`` and then ``os.rename`` (atomic on POSIX), so
a crash mid-save never corrupts the latest checkpoint; the oldest steps
past ``keep`` are removed.  :meth:`Checkpointer.save_async` copies every
leaf to host memory before it returns (the train step updates params and
the optimizer state in place, so nothing may still be reading them) and
writes the files on a thread.

Keys.  The reference names a leaf by ``jax.tree_util.keystr`` of its path
in the tree it saved, and numbers the leaves in its flatten order:
NamedTuple fields in order (a None field has no leaf), dict keys sorted,
list indices.  A ``TrainState``'s leaves are ``.params['embed']['table']``,
``.opt_state['mu']['embed']['table']``, ..., ``.step``; a bare param
tree's are ``['embed']['table']``.  The port's trees hold the same leaves
under other containers: params as nested dicts, the optimizer state keyed
by ``nn.flat_params`` paths (``"embed/table"``), ``TrainState.step`` a
Python int (saved as the reference's int32 scalar).  :func:`jax_key` and
:func:`port_path` convert between a port path and a reference key.

bfloat16 without ``ml_dtypes``: numpy has no bfloat16, and the reference
(through ``ml_dtypes``) writes such a leaf as 2-byte void (``.npy``
descr ``'<V2'``) with ``"dtype": "bfloat16"`` in the manifest.  The port
writes that header and the leaf's bits through a 16-bit integer view, and
reads a void leaf back the same way, so it needs neither ``ml_dtypes`` nor
``jax``.

Unlike the reference's (which device_puts onto a mesh), a restore fills
the template's own tensors, on their device, in place.

On a training mesh a rank's tree holds blocks of the leaves.  ``placed``
(``train.layout.MeshLayout.checkpoint_view``) names each leaf's placement:
a save all-gathers every leaf whole on every rank and the writer (rank 0,
``writer=True``) alone writes them, so the files are a single-device
save's; a restore reads every leaf whole and keeps the block of the
*current* mesh, so a checkpoint saved on one mesh restores on another
(the reference's elastic reshard).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)$")
_KEY_PART = re.compile(r"\['([^'\\]*)'\]|\[(\d+)\]")


def jax_key(path: str) -> str:
    """The reference's key of the port's parameter path: ``"blocks/attn/wq/kernel"``
    -> ``"['blocks']['attn']['wq']['kernel']"``, the keystr of the path
    (``blocks``, ``attn``, ``wq``, ``kernel``) that ``nn.from_jax_params``
    walks in the reference's tree for that leaf.  A part made of digits is
    a list index (``nn.flat_params`` writes a per-layer list's entries so):
    ``"blocks/0/ffn/up"`` -> ``"['blocks'][0]['ffn']['up']"``."""
    return "".join(f"[{part}]" if part.isdigit() else f"[{part!r}]"
                   for part in path.split("/"))


def port_path(key: str) -> str:
    """The inverse of :func:`jax_key`: a reference key made of dict keys,
    with list indices only between two of them (a param tree's root is a
    dict and its leaves are named), back to the port's ``"/"``-joined path.
    Raises ValueError for any other key (an attribute, a leading or
    trailing index)."""
    parts = ["".join(p) for p in _KEY_PART.findall(key)]
    if (not parts or parts[0].isdigit() or parts[-1].isdigit()
            or jax_key("/".join(parts)) != key):
        raise ValueError(f"not a key of the param tree: {key!r}")
    return "/".join(parts)


def _path_order(path: str):
    """Sort key of a ``"/"``-joined path in the reference's flatten order:
    dict keys as strings, list indices (digit parts) as numbers."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in path.split("/"))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(reference key, leaf) of every leaf of a port tree (a NamedTuple
    such as ``TrainState``, dicts, lists), in the reference's flatten
    order.  A mapping's keys may be ``"/"``-joined
    paths (the optimizer state's): each stands for the nested dicts it
    names, so the items sort as the reference's nested keys sort."""
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [kv for f in tree._fields for kv in leaves(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree, key=lambda k: _path_order(str(k)))
                for kv in leaves(tree[k], prefix + jax_key(str(k)))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``, keys as in
    :func:`leaves`."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, fn, prefix + jax_key(str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory, complete when this returns, as the
    array ``np.save`` writes and the manifest's dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (bool, int)) and not isinstance(leaf, np.generic):
        arr = np.asarray(leaf, dtype=np.int32)          # TrainState.step: the reference's int32
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, except that a bfloat16 leaf (``arr`` its bits as int16)
    gets the header ``ml_dtypes`` gives it, descr ``'<V2'``."""
    if dtype != "bfloat16":
        np.save(path, arr, allow_pickle=False)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        np.ascontiguousarray(arr).tofile(f)


def _from_file(path: str, entry: Dict) -> torch.Tensor:
    arr = np.load(path, allow_pickle=False)
    if arr.dtype.kind == "V":                           # bf16 (ml_dtypes) as raw bytes
        if entry["dtype"] != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"{entry['key']}: raw {arr.dtype} leaf of dtype "
                             f"{entry['dtype']!r}; only bfloat16 is read")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.c_contiguous else np.ascontiguousarray(arr))


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, writer: bool = True):
        self.directory = directory
        self.keep = keep
        self.writer = writer
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, placed=None) -> Optional[str]:
        """Synchronous atomic save (``placed``: a mesh rank's, see the
        module doc; every rank calls it, the writer writes)."""
        host = self._snapshot(tree, placed)
        return self._write(step, host) if self.writer else None

    def save_async(self, step: int, tree, placed=None) -> None:
        """Copy every leaf to host memory now; write on a background thread."""
        self.wait()
        host = self._snapshot(tree, placed)
        if self.writer:
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, tree, placed=None) -> List[Tuple[str, np.ndarray, str]]:
        out = []
        for key, leaf in leaves(tree):
            if placed is not None:
                leaf = placed.whole(key, leaf)
            if self.writer:
                out.append((key, *_to_host(leaf)))
        return out

    def _write(self, step: int, host: List[Tuple[str, np.ndarray, str]]) -> str:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        entries: List[Dict] = []
        for i, (key, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            _save(os.path.join(tmp, fname), arr, dtype)
            entries.append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype})
        manifest = {"step": step, "leaves": entries, "complete": True}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Steps with a manifest; a ``.tmp`` directory (a save that did not
        finish) is not one."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.search(name)
            if not m or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _restore_tree(self, step: int, template, lookup, placed=None):
        """Fill ``template``'s leaves from checkpoint ``step``;
        ``lookup(by_key, key)`` maps a template key to its manifest entry
        (or None).  A tensor leaf is filled in place (cast to its dtype, on
        its device; a mesh rank's block of it with ``placed``); any other
        leaf (``TrainState.step``) is replaced by the stored value as an
        int."""
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if not manifest.get("complete"):
            raise ValueError(f"checkpoint {path} incomplete")
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}

        @torch.no_grad()
        def fill(key, tmpl):
            entry = lookup(by_key, key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            value = _from_file(os.path.join(path, entry["file"]), entry)
            if placed is not None:
                value = placed.local(key, value)
            expected = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else ()
            if tuple(value.shape) != expected:
                raise ValueError(f"shape mismatch for {key}: {tuple(value.shape)} vs {expected}")
            if isinstance(tmpl, torch.Tensor):
                return tmpl.copy_(value)
            return int(value)

        return _rebuild(template, fill)

    def restore(self, step: int, template, placed=None):
        """Restore into ``template`` (the tree that was saved, or one of its
        structure: a ``TrainState``, a param tree), filling its tensors in
        place; returns the tree with any int leaf replaced.  ``placed``: a
        mesh rank's, see the module doc."""
        return self._restore_tree(step, template, lambda by_key, key: by_key.get(key), placed)

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, template), step

    # -- params-only restore (serving) --------------------------------------

    def restore_params(self, step: int, params_template):
        """Restore only the params of a ``TrainState`` checkpoint (the
        leaves keyed ``.params<key>``), or else a bare-params checkpoint's
        leaves, into ``params_template``; the optimizer and step leaves on
        disk are never read.  Each leaf is cast to the template's dtype (a
        serving tree's bf16 weights from the f32 masters), as
        ``nn.from_jax_params`` casts."""
        return self._restore_tree(
            step, params_template,
            lambda by_key, key: by_key.get(".params" + key) or by_key.get(key))

    def restore_params_latest(self, params_template):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore_params(step, params_template), step
