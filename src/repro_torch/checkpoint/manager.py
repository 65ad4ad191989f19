"""Checkpointing: atomic, rotating, async-capable, verified.

The port of ``repro/checkpoint/manager.py``, with its on-disk format:

    <dir>/step_000100.tmp/...   (written)
    <dir>/step_000100/          (atomic rename on completion)
        META.json               tree structure + shapes + dtypes + step
                                + per-leaf crc32 checksums
        <leaf-path>.npy         one file per tensor

Fault-tolerance properties, as in the JAX package:
  * atomic: a crash mid-save never corrupts the latest checkpoint (tmp dir
    + rename). ``all_steps`` only counts directories with a META.json, so a
    crash mid-rename (or a stray ``.tmp``) is invisible to
    ``latest_step``/``restore``.
  * verified: META.json records a crc32 per leaf; ``verify(step)`` checks
    existence, shape, dtype and checksum of every leaf, and
    ``restore(step=None)`` falls back to the newest checkpoint that
    verifies (with a warning) instead of crashing on a truncated or
    bit-flipped one; an explicit ``restore(step=k)`` stays strict and
    raises ``CheckpointCorruption``.
  * rotating: keep_last K checkpoints, older deleted after a save.
  * async: ``save_async`` copies the state to host memory synchronously
    and writes on a worker thread. A worker failure is re-raised as
    ``CheckpointWriteError`` carrying the step whose write failed, at the
    next save/wait/poll boundary.

What a torch state adds:
  * the snapshot copies every tensor (on the CPU ``t.cpu()`` would be the
    same storage, which the next step could change under a background
    write);
  * a ``torch.Generator`` leaf (``TrainState.rng``) is stored as its
    ``get_state()`` bytes (uint8) and restored with ``set_state`` on a
    generator on the state's device;
  * dtypes numpy lacks (bf16, fp8) are stored as their raw bits
    (uint16 / uint8 ``.npy``) with the JAX dtype name in META.json, so the
    crc covers the bytes JAX's would.
``restore(..., device=)`` puts the leaves on one device. With
``shardings`` (the sharded engine's ``StateShardings``, the counterpart of
the JAX ``restore(shardings=)``) the manager serves a world of ranks: a
save gathers the whole leaves and the first rank writes them, in the same
format, so the bytes and crcs are a world-1 run's; a restore reads the
whole leaves and keeps this rank's slices, so a checkpoint moves between
world sizes (elastic re-mesh). ``wait`` ends with a barrier, so every rank
then lists the same directories, and a failed write is raised on every
rank at the same boundary. Leaves are
written, loaded and checksummed on a pool of threads (numpy's file I/O and
zlib's crc32 release the GIL); a verification still reports the first
bad leaf in the order the JAX package checks them.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch


class CheckpointCorruption(RuntimeError):
    """A checkpoint directory failed integrity verification."""

    def __init__(self, step: int, reason: str):
        super().__init__(f"checkpoint step {step} corrupt: {reason}")
        self.step = step
        self.reason = reason


class CheckpointWriteError(RuntimeError):
    """An async checkpoint write failed; ``step`` names the save."""

    def __init__(self, step: int, cause: BaseException):
        super().__init__(f"checkpoint write for step {step} failed: {cause!r}")
        self.step = step
        self.__cause__ = cause


#: torch dtypes numpy lacks -> (JAX dtype name, numpy dtype of the stored
#: bits, a numpy dtype of that width that torch reads)
_RAW_BITS = {torch.bfloat16: ("bfloat16", np.uint16, np.int16),
             torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, np.uint8),
             torch.float8_e5m2: ("float8_e5m2", np.uint8, np.uint8)}
_BY_NAME = {v[0]: (tdt, *v[1:]) for tdt, v in _RAW_BITS.items()}
_TORCH_INT = {np.int16: torch.int16, np.uint8: torch.uint8}


class _RawBits:
    """A host leaf held as raw bits: ``bits`` (numpy) and the dtype name."""
    __slots__ = ("bits", "dtype")

    def __init__(self, bits: np.ndarray, dtype: str):
        self.bits, self.dtype = bits, dtype


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (JAX's ``tobytes``), read in
    place."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)) & 0xFFFFFFFF


#: threads that write, load and checksum a checkpoint's leaves
IO_THREADS = min(8, os.cpu_count() or 1)


def _each(fn, items) -> list:
    """``fn`` over ``items`` on IO_THREADS threads, results in order (the
    first exception in order is raised)."""
    with concurrent.futures.ThreadPoolExecutor(IO_THREADS) as pool:
        return list(pool.map(fn, items))


def _to_host(x):
    """One leaf as a host value that owns its memory."""
    if isinstance(x, torch.Generator):
        return x.get_state().clone().numpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype in _RAW_BITS:
            name, stored, readable = _RAW_BITS[t.dtype]
            bits = t.view(_TORCH_INT[readable]).to("cpu", copy=True)
            return _RawBits(bits.numpy().view(stored), name)
        return t.to("cpu", copy=True).numpy()
    return np.array(x)


def _host_snapshot(tree):
    """Device -> host copy of a state tree (dicts, lists, tuples and
    NamedTuples of tensors, Generators or host values)."""
    if isinstance(tree, dict):
        return {k: _host_snapshot(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_host_snapshot(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_snapshot(v) for v in tree)
    return _to_host(tree)


def _flatten_with_paths(tree, prefix=""):
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}{i}/")
    elif hasattr(tree, "_fields"):     # NamedTuple
        for k in tree._fields:
            out += _flatten_with_paths(getattr(tree, k), f"{prefix}{k}/")
    else:
        out.append((prefix[:-1], tree))
    return out


def _tree_structure(tree):
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _tree_structure(v) for k, v in tree.items()}}
    if hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "cls": type(tree).__name__,
                "fields": {k: _tree_structure(getattr(tree, k))
                           for k in tree._fields}}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def _stored_dtype(name: str) -> str:
    """The numpy dtype a leaf recorded as ``name`` is stored in."""
    return np.dtype(_BY_NAME[name][1]).name if name in _BY_NAME else name


def _place(arr: np.ndarray, dtype: str, ref, device):
    """A loaded leaf as the restored value: a Generator where ``ref`` is
    one, a tensor on ``device`` (in ``ref``'s dtype where ``ref`` is a
    tensor) when a device is given, else the stored numpy array."""
    if isinstance(ref, torch.Generator):
        gen = torch.Generator(device=ref.device if device is None else device)
        gen.set_state(torch.from_numpy(np.array(arr, dtype=np.uint8)))
        return gen
    if device is None:
        return arr
    if dtype in _BY_NAME:
        tdt, _, readable = _BY_NAME[dtype]
        t = torch.from_numpy(arr.view(readable)).view(tdt)
    else:
        t = torch.from_numpy(arr)
    if isinstance(ref, torch.Tensor):
        t = t.to(dtype=ref.dtype)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, shardings=None):
        self.directory = directory
        self.keep_last = keep_last
        self.shardings = shardings
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    @property
    def _writes(self) -> bool:
        return self.shardings is None or self.shardings.is_writer

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()
        if self.shardings is not None:
            tree = self.shardings.gather(tree)
        if self._writes:
            self._write(step, _host_snapshot(tree), extra or {})
        if self.shardings is not None:
            self.shardings.barrier()

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot synchronously (device -> host copy), write in background."""
        self.wait()
        if self.shardings is not None:
            tree = self.shardings.gather(tree)
        if not self._writes:
            return
        host_tree = _host_snapshot(tree)

        def work():
            try:
                self._write(step, host_tree, extra or {})
            except BaseException as e:     # propagate on next wait()
                self._error = CheckpointWriteError(step, e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.shardings is not None:
            self.shardings.barrier()
        self.poll_error()

    def poll_error(self):
        """Raise a completed worker's failure without blocking on a live
        write: the trainer polls this at every checkpoint boundary so a
        failed save surfaces at the boundary that caused it (on every rank:
        the writer's verdict is broadcast)."""
        err = None
        if not (self._thread is not None and self._thread.is_alive()):
            err, self._error = self._error, None
        if self.shardings is not None:
            step = self.shardings.writer_value(-1 if err is None else err.step)
            if err is None and step >= 0:
                err = CheckpointWriteError(step, RuntimeError("the writing rank's write failed"))
        if err is not None:
            raise err

    def _write(self, step: int, host_tree, extra: Dict):
        name = f"step_{step:08d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        leaves = _flatten_with_paths(host_tree)

        def write(item):
            path, leaf = item
            if isinstance(leaf, _RawBits):
                arr, dtype = leaf.bits, leaf.dtype
            else:
                arr = np.asarray(leaf)
                dtype = str(arr.dtype)
            fn = path.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            return {"file": fn, "shape": list(arr.shape), "dtype": dtype,
                    "crc32": _crc32(arr)}

        meta = {"step": step, "extra": extra,
                "structure": _tree_structure(host_tree),
                "leaves": dict(zip((p for p, _ in leaves), _each(write, leaves)))}
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._rotate()

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        """Steps with a complete directory: a ``.tmp`` suffix or a missing
        META.json (crash mid-rename / mid-write artifacts) doesn't count."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    s = int(d[5:])
                except ValueError:
                    continue
                if os.path.exists(os.path.join(self.directory, d,
                                               "META.json")):
                    out.append(s)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------------- verify
    def _read_meta(self, step: int) -> Dict:
        d = os.path.join(self.directory, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "META.json")) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruption(step, f"META.json unreadable: {e}")

    def _load_verified(self, step: int, keep: bool = True):
        """(META, {leaf path: array}) of one checkpoint, every leaf loaded
        and checked for the recorded shape, dtype and crc32 (the arrays
        dropped after the check unless ``keep``). Raises
        ``CheckpointCorruption`` on the first violation in leaf order."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        meta = self._read_meta(step)

        def load(item):
            """(array or None, what is wrong with the leaf or None)."""
            path, info = item
            try:
                arr = np.load(os.path.join(d, info["file"]))
            except (OSError, ValueError) as e:
                return None, f"leaf {path}: {e}"
            if list(arr.shape) != info["shape"]:
                return None, (f"leaf {path}: shape {list(arr.shape)} != "
                              f"recorded {info['shape']}")
            if str(arr.dtype) != _stored_dtype(info["dtype"]):
                return None, (f"leaf {path}: dtype {arr.dtype} != "
                              f"recorded {info['dtype']}")
            # crc32 absent in pre-verification checkpoints: shape/dtype only
            if "crc32" in info and _crc32(arr) != info["crc32"]:
                return None, f"leaf {path}: crc mismatch"
            return (arr if keep else None), None

        items = list(meta["leaves"].items())
        loaded = _each(load, items)
        for arr, bad in loaded:
            if bad is not None:
                raise CheckpointCorruption(step, bad)
        return meta, {path: arr for (path, _), (arr, _) in zip(items, loaded)}

    def verify(self, step: int) -> None:
        """Full integrity check of one checkpoint: META parses and every
        leaf file loads with the recorded shape, dtype and crc32. Raises
        ``CheckpointCorruption`` on the first violation."""
        self._load_verified(step, keep=False)

    def valid_steps(self, max_step: Optional[int] = None):
        """Steps that pass full verification, oldest -> newest (the
        supervisor's rewind ladder walks this list backwards)."""
        out = []
        for s in self.all_steps():
            if max_step is not None and s > max_step:
                continue
            try:
                self.verify(s)
            except CheckpointCorruption:
                continue
            out.append(s)
        return out

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                device: Any = None):
        """Load checkpoint ``step`` (default: the newest that passes
        verification; a truncated or mid-rename directory is skipped with
        a warning). An explicit ``step`` is strict: corruption raises.
        With ``like``, NamedTuple classes are recovered from it and a
        ``torch.Generator`` leaf of ``like`` comes back as a Generator with
        the stored state; with ``device`` every other leaf comes back as a
        tensor there (in ``like``'s dtype), else as the stored numpy array.
        Returns ``(tree, step, extra)``; each leaf is read once. With
        ``shardings`` the tree is this rank's slices of the whole leaves."""
        self.wait()
        if step is None:
            last_err: Optional[CheckpointCorruption] = None
            for s in reversed(self.all_steps()):
                try:
                    meta, arrays = self._load_verified(s)
                except CheckpointCorruption as e:
                    warnings.warn(f"skipping corrupt checkpoint: {e}")
                    last_err = e
                    continue
                step = s
                break
            if step is None:
                if last_err is not None:
                    raise last_err
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        else:
            meta, arrays = self._load_verified(step)

        def child(ref, key):
            if isinstance(ref, dict):
                return ref.get(key)
            if hasattr(ref, "_fields"):
                return getattr(ref, key, None)
            if isinstance(ref, (list, tuple)) and isinstance(key, int) and key < len(ref):
                return ref[key]
            return None

        def rebuild(struct, ref, prefix=""):
            kind = struct["__kind__"]
            if kind == "leaf":
                path = prefix[:-1]
                return _place(arrays[path], meta["leaves"][path]["dtype"], ref, device)
            if kind == "dict":
                return {k: rebuild(v, child(ref, k), f"{prefix}{k}/")
                        for k, v in struct["items"].items()}
            if kind in ("list", "tuple"):
                vals = [rebuild(v, child(ref, i), f"{prefix}{i}/")
                        for i, v in enumerate(struct["items"])]
                return vals if kind == "list" else tuple(vals)
            if kind == "namedtuple":
                vals = {k: rebuild(v, child(ref, k), f"{prefix}{k}/")
                        for k, v in struct["fields"].items()}
                if like is not None:
                    # recover the concrete NamedTuple class from `like`
                    cls_ref = _find_namedtuple(like, struct["cls"])
                    if cls_ref is not None:
                        return type(cls_ref)(**vals)
                return vals
            raise ValueError(kind)

        tree = rebuild(meta["structure"], like)
        if self.shardings is not None:
            tree = self.shardings.local(tree)
        return tree, meta["step"], meta["extra"]


def _find_namedtuple(tree, cls_name):
    if hasattr(tree, "_fields") and type(tree).__name__ == cls_name:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            r = _find_namedtuple(v, cls_name)
            if r is not None:
                return r
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            r = _find_namedtuple(v, cls_name)
            if r is not None:
                return r
    return None
