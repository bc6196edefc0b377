"""Checkpoint / resume of distributed training state.

Counterpart of ``bluefog_tpu/checkpoint.py``, with
``torch.distributed.checkpoint`` (DCP) in place of orbax. The state of an
optimizer wrapper (``bluefog_tpu_torch.optimizers``) is its model's
``state_dict`` (parameters and buffers: JAX's ``params`` and
``model_state``), its optimizer's ``state_dict`` (``opt_state``; for ZeRO-1,
the shard optimizer ``opt.base``) and the step.

Decentralized caveat: every rank's parameters differ between communication
rounds, so every rank's state must be saved, not one replica. DCP's default
planner takes entries that share a key on several ranks for copies of one
replicated tensor and writes only one of them; so every entry here is keyed
by its rank (``rank<r>/model/<name>``, ``rank<r>/optim/...``), and each rank
writes, and reads back, its own. Every rank calls ``save``, ``save_async``
and ``restore`` together. DCP coordinates over a gloo group (the world
itself under gloo), which its asynchronous save requires.

The world-identity sidecar ``<path>.bf_meta.json`` sits next to the
directory, with JAX's fields: ``step``, ``world``, ``process_count`` (the
port's processes, one per rank), ``topology_crc`` and ``membership_epoch``
(``runtime/heartbeat.py``; 0 with no control plane).
"""

from __future__ import annotations

import atexit
import io
import json
import os
import re
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata

from . import topology as topology_util
from .runtime.logging import logger
from .runtime.state import _global_state

_META_SUFFIX = ".bf_meta.json"


def _meta_path(path: str) -> str:
    return os.path.abspath(path) + _META_SUFFIX


def _topology_crc(st) -> Optional[int]:
    if st.topology is None:
        return None
    W = topology_util.weight_matrix(st.topology)
    return int(zlib.crc32(np.ascontiguousarray(W).tobytes()))


def _runtime_meta(step: int) -> dict:
    """World identity at save time (world size, topology fingerprint,
    membership epoch): what ``restore`` checks so that a checkpoint is not
    silently resumed onto a different world."""
    meta = {"step": int(step)}
    st = _global_state()
    if st.initialized:
        meta["world"] = int(st.size)
        meta["process_count"] = int(dist.get_world_size())
        crc = _topology_crc(st)
        if crc is not None:
            meta["topology_crc"] = crc
        try:
            from .runtime.heartbeat import membership_epoch

            meta["membership_epoch"] = int(membership_epoch())
        except Exception:  # noqa: BLE001 — the sidecar must still be written
            pass
    return meta


def _write_meta(path: str, step: int) -> None:
    try:
        with open(_meta_path(path), "w") as f:
            json.dump(_runtime_meta(step), f)
    except OSError as exc:
        logger.warning("checkpoint meta sidecar write failed (%s)", exc)


def read_meta(path: str) -> Optional[dict]:
    """The checkpoint's world-identity sidecar, or None when it is absent."""
    try:
        with open(_meta_path(path)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _check_meta(path: str, strict: bool) -> None:
    meta = read_meta(path)
    st = _global_state()
    if meta is None or not st.initialized:
        return
    mismatches = []
    if "world" in meta and int(meta["world"]) != st.size:
        mismatches.append(
            f"world size {meta['world']} (saved) vs {st.size} (current)")
    crc = _topology_crc(st)
    if "topology_crc" in meta and crc is not None and \
            int(meta["topology_crc"]) != crc:
        mismatches.append(
            "topology fingerprint differs (the combine matrix changed "
            "since the save)")
    if not mismatches:
        return
    msg = (f"checkpoint {path} was saved on a different world: "
           + "; ".join(mismatches)
           + ". Decentralized state is per rank — resuming it onto a "
           "mismatched world silently mis-assigns per-rank parameters.")
    if strict:
        raise RuntimeError(msg)
    logger.warning("%s Resuming anyway (pass strict=True to refuse).", msg)


def latest_path(directory: str) -> Optional[str]:
    """Newest checkpoint directory under ``directory`` (by mtime), or None."""
    try:
        entries = [os.path.join(directory, e) for e in os.listdir(directory)]
    except OSError:
        return None
    dirs = [e for e in entries if os.path.isdir(e)]
    return max(dirs, key=os.path.getmtime) if dirs else None


def _group():
    """The group DCP coordinates over: the world under gloo, else a gloo
    group over the world made once per ``init`` (every rank reaches its
    first checkpoint call together, as ``new_group`` needs)."""
    st = _global_state()
    st.check_initialized()
    if st.checkpoint_group is None:
        st.checkpoint_group = dist.group.WORLD \
            if dist.get_backend() == "gloo" else dist.new_group(
                backend="gloo")
    return st.checkpoint_group


def _as_state_dict(opt, step: int) -> dict:
    """This rank's entries, keyed by rank. Tensors stay tensors; the
    optimizer's non-tensor leaves and param groups go as one
    ``torch.save`` blob each."""
    prefix = f"rank{_global_state().rank}/"
    sd = {prefix + "model/" + k: v for k, v in opt.model.state_dict().items()}
    osd = opt.base.state_dict()
    for idx, entry in osd["state"].items():
        for name, val in entry.items():
            key = f"{prefix}optim/state/{idx}/{name}"
            sd[key] = val if torch.is_tensor(val) else _blob(val)
    sd[prefix + "optim/param_groups"] = _blob(osd["param_groups"])
    sd["meta/step"] = int(step)
    return sd


def _blob(obj) -> io.BytesIO:
    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


def _unblob(buf: io.BytesIO):
    buf.seek(0)
    return torch.load(buf, weights_only=True)


def _prepare(path: str, force: bool) -> str:
    path = os.path.abspath(path)
    if not force and os.path.exists(path):
        raise FileExistsError(f"checkpoint {path} exists (pass force=True "
                              f"to overwrite it)")
    return path


def save(path: str, opt, step: int = 0, *, force: bool = True) -> str:
    """Write a checkpoint directory at ``path`` (overwrites when
    ``force``); ``opt`` is the optimizer wrapper."""
    group = _group()
    wait_pending()  # never interleave with an in-flight async save
    path = _prepare(path, force)
    dcp.save(_as_state_dict(opt, step), process_group=group,
             storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    if _global_state().rank == 0:
        _write_meta(path, step)
    logger.info("checkpoint saved to %s (step %d)", path, step)
    return path


_pending = None  # the in-flight async save's future
# a script whose LAST action is save_async must still commit before exit
atexit.register(lambda: wait_pending())


def save_async(path: str, opt, step: int = 0, *, force: bool = True) -> str:
    """Start writing a checkpoint WITHOUT blocking the training loop.

    DCP copies the state to host memory before this returns, then writes
    it from a background thread while the next steps run. A second
    ``save_async`` (or a :func:`save`) first waits for the one in flight;
    :func:`wait_pending` forces completion (call it before reading the
    directory or exiting).
    """
    global _pending
    group = _group()
    wait_pending()
    path = _prepare(path, force)
    _pending = dcp.async_save(
        _as_state_dict(opt, step), process_group=group,
        storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    # the sidecar holds host-side values known now; it lives next to the
    # directory, not inside it
    if _global_state().rank == 0:
        _write_meta(path, step)
    logger.info("async checkpoint started to %s (step %d)", path, step)
    return path


def wait_pending() -> None:
    """Block until any in-flight :func:`save_async` has committed; raises
    what the write raised."""
    global _pending
    fut, _pending = _pending, None
    if fut is not None:
        fut.result()


_OPT_KEY = re.compile(r"optim/state/(\d+)/(.+)$")


def restore(path: str, template, strict: bool = False, *,
            collective: bool = True) -> Tuple[object, int]:
    """Load this rank's state from ``path`` into the optimizer wrapper
    ``template`` (its model and optimizer, in place; the optimizer may have
    no state yet); returns ``(template, step)``.

    The world-identity sidecar is checked against the current runtime: a
    mismatch warns by default and raises with ``strict=True``. The
    optimizer's state comes through host memory and is placed by
    ``load_state_dict`` as ``torch.optim`` places it (by each parameter).
    ``collective=False`` reads this rank's entries alone, with no other
    rank taking part (a quarantined rejoiner's fallback: its peers are
    mid-training).
    """
    group = _group() if collective else None
    wait_pending()  # an in-flight async save may target this very path
    path = os.path.abspath(path)
    _check_meta(path, strict)
    prefix = f"rank{_global_state().rank}/"
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata()
    model_sd = template.model.state_dict()
    sd = {prefix + "model/" + k: v for k, v in model_sd.items()}
    sd["meta/step"] = None
    for key, item in meta.state_dict_metadata.items():
        if not key.startswith(prefix + "optim/"):
            continue
        if isinstance(item, TensorStorageMetadata):
            sd[key] = torch.empty(item.size, dtype=item.properties.dtype)
        else:
            sd[key] = io.BytesIO()
    dcp.load(sd, storage_reader=reader, process_group=group,
             no_dist=not collective)
    state = {}
    for key, val in sd.items():
        hit = _OPT_KEY.search(key) if key.startswith(prefix) else None
        if hit:
            state.setdefault(int(hit.group(1)), {})[hit.group(2)] = \
                val if torch.is_tensor(val) else _unblob(val)
    template.base.load_state_dict({
        "state": state,
        "param_groups": _unblob(sd[prefix + "optim/param_groups"])})
    return template, int(sd["meta/step"])
