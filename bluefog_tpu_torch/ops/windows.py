"""One-sided "window" ops: the asynchronous gossip subsystem.

Counterpart of ``bluefog_tpu/ops/windows.py`` (the hybrid executor,
``:1783-2040``, is not ported yet). The emulation is the JAX package's
**mailbox model**: every window keeps, per rank, one receive slot per
in-neighbour (slot k of rank r belongs to its k-th sorted in-neighbour,
the MPI_Dist_graph order) plus the rank's own window tensor. Each process
passes ITS OWN rank's tensor, as in BlueFog's torch API:

* ``win_put(tensor, name, self_weight, dst_weights, require_mutex)``:
  ``dst_weights`` is a float or ``{dst: w}`` for this rank (the JAX
  package's nested ``{rank: {dst: w}}`` form is read at this rank's row);
* ``win_accumulate`` alike; ``win_get(name, src_weights={src: w})``;
* ``win_update(name, self_weight, neighbor_weights={src: w}, reset,
  clone, require_mutex)`` returns this rank's combined tensor:
  ``sw * self + sum_k nw[k] * mail[k]``.

Two data planes, chosen as the JAX package chooses them
(:func:`_plane_policy`, :func:`_hosted_mode_enabled`):

* **collective** (the default without a control plane): each op is a
  lockstep exchange over the process group, one ``batch_isend_irecv``
  round per circulant shift of :class:`_GraphLayout`, followed by the slot
  blend in the accumulation dtype on the window tensor's device. The
  mailbox is ``[d_max + 1, ...]`` on that device; slot ``d_max`` is the
  scratch slot an inactive write lands in. A receiver cannot see its
  in-neighbour's weight table, so every static edge carries its payload
  on every call together with ``(active, weight, p)``: an inactive write
  goes to the scratch slot, as the JAX program's does.
* **hosted** (the default with a control plane of more than one
  controller, which ``bf.init`` attaches under ``torchrun``): the window
  rows live on the host; an origin deposits into the owner's bulk-bytes
  mailbox on the control-plane server (``append_bytes_tagged_many``) and
  returns without waiting; the owner drains and folds at its next
  ``win_update``. Each rank's row is published so ``win_get`` stays
  one-sided. Deposits may ride a codec (``ops/codec.py``). The records are
  the JAX package's, byte for byte.

Scalar protocols (versions, push-sum p, mutexes): with a control plane,
both planes keep them on the server under the JAX package's keys
(``w.<name>.v.<dst>.<k>``, ``.p.<r>``, ``.m.<r>.<k>``, ``.mu.<r>``; p as the
bits of an f64). Without one, each process keeps its own rank's: the
receiving side of the exchange bumps its slots' versions, the p mail rides
the exchange as one f64 per edge, and ``require_mutex=True`` raises at a
world of more than one (a lock that excludes nobody would be worse).
``win_associated_p_all`` is then an all-gather every rank must call.

The device-side steps of the collective plane are module functions
(:func:`fold_arrival` over :func:`blend_arrival`, :func:`combine`,
:func:`p_combine`), which ``chip_smoke.py`` drives for a virtual group of
ranks.
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .. import topology as topology_util
from . import codec as _wire_codec
from .codec import cast
from .fusion import from_host, host_dtype, to_host
from ..runtime import control_plane as _cp
from ..runtime import flight as _flight
from ..runtime import handles as _handles
from ..runtime import metrics as _metrics
from ..runtime import native as _native
from ..runtime.config import knob_env
from ..runtime.logging import logger
from ..runtime.state import _global_state
from ..runtime.timeline import (timeline_context, timeline_counter,
                                timeline_flow_finish, timeline_flow_start)

Weights = Union[float, Dict[int, float], Dict[int, Dict[int, float]]]


def _op_timer(activity: str):
    """Latency histogram of one window op ('WIN_PUT' -> ``win.put_sec``)."""
    return _metrics.timed(f"win.{activity[4:].lower()}_sec")


# Flow-event name binding a deposit on the origin to its drain at the owner
# (flow id = the deposit tag's (origin << 32 | counter) sequence).
_FLOW_DEPOSIT = "WIN_DEPOSIT"


class _LocalWinHost:
    """Process-local scalar state: versions, push-sum p, rank mutexes.

    At a world of one the process holds every rank, and this is the JAX
    package's ``_LocalWinHost``. At a larger world without a control plane
    each process keeps its own rank's entries only: the exchange delivers
    the p mail and the receiver bumps its own versions. Reading another
    rank's version then raises; reading every rank's p is an all-gather;
    its mutexes are never taken there (``_check_mutex_world``).
    """

    def __init__(self, name: str, n: int, d_max: int, rank: int) -> None:
        self.n = n
        self.d_max = d_max
        self.rank = rank
        self.owned = set(range(n)) if n == 1 else {rank}
        self.version = np.zeros((n, d_max), np.int64)
        self.p = np.ones(n, np.float64)
        self.p_mail = np.zeros((n, d_max), np.float64)
        self.mutexes = [threading.RLock() for _ in range(n)]

    def bump_versions(self, pairs, force: bool = False,
                      delta: int = 1) -> None:
        for dst, k in pairs:
            self.version[dst, k] += delta

    def reset_versions(self, pairs) -> None:
        for dst, k in pairs:
            self.version[dst, k] = 0

    def _check_readable(self, rank: int) -> None:
        if rank not in self.owned:
            raise ValueError(
                f"rank {rank}'s window versions live in its own process; "
                "without a control plane a process reads only its own "
                f"rank's ({self.rank})")

    def get_version(self, dst: int, k: int) -> int:
        self._check_readable(dst)
        return int(self.version[dst, k])

    def get_versions(self, pairs) -> List[int]:
        return [self.get_version(dst, k) for dst, k in pairs]

    def read_p(self) -> np.ndarray:
        if self.n == 1:
            return self.p.copy()
        # every rank's p: one all-gather, which every rank must call
        dev = _global_state().device
        mine = torch.tensor([self.p[self.rank]], dtype=torch.float64,
                            device=dev)
        parts = [torch.zeros_like(mine) for _ in range(self.n)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).cpu().numpy()

    def read_p_owned(self) -> Dict[int, float]:
        return {r: float(self.p[r]) for r in sorted(self.owned)}

    def read_p_mail_owned(self) -> Dict[int, np.ndarray]:
        return {r: self.p_mail[r].copy() for r in sorted(self.owned)}

    def write_p_entries(self, entries: Dict[int, float]) -> None:
        for r, v in entries.items():
            self.p[r] = v

    def write_p_mail_rows(self, rows: Dict[int, np.ndarray]) -> None:
        for r, v in rows.items():
            self.p_mail[r] = np.asarray(v, np.float64)

    def add_p_mail(self, dst: int, k: int, v: float) -> None:
        self.p_mail[dst, k] += v

    def set_p_mail(self, dst: int, k: int, v: float) -> None:
        self.p_mail[dst, k] = v

    def mutex_acquire(self, rank: int) -> None:
        self.mutexes[rank].acquire()

    def mutex_release(self, rank: int) -> None:
        self.mutexes[rank].release()

    def op_mutex_ranks(self, touched) -> List[int]:
        return sorted(set(touched) & self.owned)

    def flush(self) -> None:
        pass


class _ControlPlaneWinHost:
    """Shared scalar state over the control plane (the JAX package's keys,
    p as the bits of an f64, its mutex protocol).

    Writes are ownership-partitioned: only the process owning rank r writes
    r's scalars; ``flush`` barriers every controller so reads after an op
    are consistent. Origins of the hosted plane bump a remote slot's
    version with ``force`` (slot (dst, k) maps 1:1 to one source rank).
    """

    def __init__(self, name: str, n: int, d_max: int,
                 owned: Sequence[int]) -> None:
        self.n = n
        self.d_max = d_max
        self.owned = set(owned)
        self._cl = _cp.client()
        self._pre = f"w.{name}"
        # a quarantined rejoiner starts with ZERO push-sum mass (its old
        # mass died with its previous incarnation) and must not barrier:
        # the survivors are mid-loop and will never arrive
        from ..runtime.heartbeat import quarantine_pending

        rejoining = quarantine_pending()
        p_init = 0.0 if rejoining else 1.0
        # The server lock is re-entrant per client rank but not recursion
        # counted: count recursion locally, and make each rank's depth
        # transitions and its server lock/unlock one step under a per-rank
        # gate.
        self._mu_depth: Dict[int, int] = {}
        self._mu_gates: Dict[int, threading.Lock] = {}
        self._mu_depth_lock = threading.Lock()
        for dst in self.owned:
            _cp.put_float(self._cl, f"{self._pre}.p.{dst}", p_init)
            for k in range(d_max):
                self._cl.put(f"{self._pre}.v.{dst}.{k}", 0)
                _cp.put_float(self._cl, f"{self._pre}.m.{dst}.{k}", 0.0)
        if not rejoining:
            self.flush()

    def bump_versions(self, pairs, force: bool = False,
                      delta: int = 1) -> None:
        """Batched bump, one pipelined round-trip; ``delta=-1`` rolls back
        deposits that never landed."""
        keys = [f"{self._pre}.v.{dst}.{k}" for dst, k in pairs
                if force or dst in self.owned]
        if keys:
            self._cl.fetch_add_many(keys, deltas=[delta] * len(keys))

    def reset_versions(self, pairs) -> None:
        keys = [f"{self._pre}.v.{dst}.{k}" for dst, k in pairs
                if dst in self.owned]
        if keys:
            self._cl.put_many(keys, [0] * len(keys))

    def get_version(self, dst: int, k: int) -> int:
        return int(self._cl.get(f"{self._pre}.v.{dst}.{k}"))

    def get_versions(self, pairs) -> List[int]:
        return [int(v) for v in self._cl.get_many(
            [f"{self._pre}.v.{dst}.{k}" for dst, k in pairs])]

    @staticmethod
    def _bits_to_float(v: int) -> float:
        return struct.unpack("<d", struct.pack("<q", v))[0]

    @staticmethod
    def _float_to_bits(v: float) -> int:
        return struct.unpack("<q", struct.pack("<d", float(v)))[0]

    def read_p(self) -> np.ndarray:
        vals = self._cl.get_many(
            [f"{self._pre}.p.{r}" for r in range(self.n)])
        return np.array([self._bits_to_float(v) for v in vals])

    def read_p_owned(self) -> Dict[int, float]:
        owned = sorted(self.owned)
        vals = self._cl.get_many([f"{self._pre}.p.{r}" for r in owned])
        return {r: self._bits_to_float(v) for r, v in zip(owned, vals)}

    def read_p_mail_owned(self) -> Dict[int, np.ndarray]:
        owned = sorted(self.owned)
        keys = [f"{self._pre}.m.{r}.{k}"
                for r in owned for k in range(self.d_max)]
        vals = self._cl.get_many(keys)
        out: Dict[int, np.ndarray] = {}
        i = 0
        for r in owned:
            out[r] = np.array([self._bits_to_float(v)
                               for v in vals[i:i + self.d_max]])
            i += self.d_max
        return out

    def write_p_entries(self, entries: Dict[int, float]) -> None:
        items = sorted(entries.items())
        self._cl.put_many([f"{self._pre}.p.{r}" for r, _ in items],
                          [self._float_to_bits(v) for _, v in items])

    def write_p_mail_rows(self, rows: Dict[int, np.ndarray]) -> None:
        keys, vals = [], []
        for r in sorted(rows):
            for k in range(self.d_max):
                keys.append(f"{self._pre}.m.{r}.{k}")
                vals.append(self._float_to_bits(float(rows[r][k])))
        self._cl.put_many(keys, vals)

    def add_p_mail(self, dst: int, k: int, v: float) -> None:
        if dst in self.owned:
            key = f"{self._pre}.m.{dst}.{k}"
            _cp.put_float(self._cl, key, _cp.get_float(self._cl, key) + v)

    def set_p_mail(self, dst: int, k: int, v: float) -> None:
        if dst in self.owned:
            _cp.put_float(self._cl, f"{self._pre}.m.{dst}.{k}", v)

    def _mu_gate(self, rank: int) -> threading.Lock:
        with self._mu_depth_lock:
            gate = self._mu_gates.get(rank)
            if gate is None:
                gate = self._mu_gates[rank] = threading.Lock()
            return gate

    def mutex_acquire(self, rank: int) -> None:
        # the gate is held ACROSS the blocking server call: a second local
        # thread waits here instead of seeing depth > 0 before the lock
        # is granted
        from ..runtime.native import PeerLostError

        with self._mu_gate(rank):
            depth = self._mu_depth.get(rank, 0)
            if depth == 0:
                try:
                    self._cl.lock(f"{self._pre}.mu.{rank}")
                except PeerLostError as exc:
                    raise PeerLostError(
                        f"window mutex for rank {rank}: holder died "
                        f"mid-hold ({exc.args[0] if exc.args else exc}); "
                        "re-acquire to continue on the shrunken topology",
                        dead=exc.dead) from exc
            self._mu_depth[rank] = depth + 1

    def mutex_release(self, rank: int) -> None:
        from ..runtime.native import PeerLostError

        with self._mu_gate(rank):
            depth = self._mu_depth.get(rank, 0) - 1
            if depth < 0:
                raise RuntimeError(f"mutex for rank {rank} released more "
                                   "times than acquired")
            self._mu_depth[rank] = depth
            if depth == 0:
                try:
                    self._cl.unlock(f"{self._pre}.mu.{rank}")
                except PeerLostError as exc:
                    # force-released out from under this holder: release
                    # paths run in finally blocks, so warn instead of
                    # masking the section's own result
                    logger.warning(
                        "window mutex for rank %d was force-released while "
                        "held (%s): exclusion may have been broken for the "
                        "section just completed", rank, exc)

    def op_mutex_ranks(self, touched) -> List[int]:
        # each controller locks only the touched ranks it owns
        return sorted(set(touched) & self.owned)

    def flush(self) -> None:
        _cp.barrier(self._pre)


def _win_acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype of the weighted mailbox math: f32 for integer
    windows (fractional weights) and for sub-f32 floats."""
    if not dtype.is_floating_point:
        return torch.float32
    return torch.float32 if dtype.itemsize < 4 else dtype


def _win_mail_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _win_wire_dtype(mail_dtype: torch.dtype) -> np.dtype:
    """Host dtype of deposit payloads: the window's own float dtype (bf16
    as ``codec.BF16``), f32 for integer windows."""
    if mail_dtype.is_floating_point:
        return host_dtype(mail_dtype)
    return host_dtype(_win_acc_dtype(mail_dtype))


class _GraphLayout:
    """Static decomposition of the window's edge set into circulant shifts."""

    def __init__(self, topology, n: int) -> None:
        self.n = n
        self.in_nbrs = {
            r: topology_util.in_neighbor_ranks(topology, r) for r in range(n)
        }
        self.out_nbrs = {
            r: topology_util.out_neighbor_ranks(topology, r) for r in range(n)
        }
        self.d_max = max((len(v) for v in self.in_nbrs.values()),
                         default=0) or 1
        shifts = sorted({
            (dst - src) % n
            for dst, srcs in self.in_nbrs.items() for src in srcs
        })
        self.shifts: Tuple[int, ...] = tuple(shifts)
        self.shift_index = {s: i for i, s in enumerate(shifts)}
        S = max(len(shifts), 1)
        # slot[si, dst] = mailbox slot of src=(dst-shift)%n at dst; 0 when
        # the edge does not exist (has_edge says which)
        self.slot = np.zeros((S, n), np.int32)
        self.has_edge = np.zeros((S, n), bool)
        self.slot_of = {
            r: {src: k for k, src in enumerate(self.in_nbrs[r])}
            for r in range(n)
        }
        for si, s in enumerate(shifts):
            for dst in range(n):
                src = (dst - s) % n
                k = self.slot_of[dst].get(src)
                if k is not None:
                    self.slot[si, dst] = k
                    self.has_edge[si, dst] = True


def _plane_policy() -> Tuple[str, Optional[bool]]:
    """``(policy, hosted_forced)`` from ``BFT_WIN_PLANE``: ``auto``
    (hosted iff a control plane of more than one controller), ``compiled``
    (collective plane forced) or ``hosted`` (mailbox plane forced)."""
    raw = knob_env("BFT_WIN_PLANE")
    if raw:
        raw = str(raw).lower()
        if raw not in ("auto", "compiled", "hosted"):
            logger.warning(
                "BFT_WIN_PLANE=%r is not auto|compiled|hosted; treating it "
                "as auto", raw)
            raw = "auto"
        if raw == "hosted":
            return "hosted", True
        if raw == "compiled":
            return "compiled", False
    return "auto", None


def _hosted_mode_enabled(policy: Optional[Tuple[str, Optional[bool]]] = None
                         ) -> bool:
    """Whether new windows use the hosted data plane: never without a
    control plane; forced either way by ``BFT_WIN_PLANE``; otherwise iff
    the control plane spans more than one controller."""
    if not _cp.active():
        return False
    _, forced = policy if policy is not None else _plane_policy()
    if forced is not None:
        return forced
    return _cp.world() > 1


# ---------------------------------------------------------------------------
# The collective plane's device-side steps (one rank; chip_smoke.py drives
# them for a virtual group)
# ---------------------------------------------------------------------------

def blend_arrival(mail: torch.Tensor, moved: torch.Tensor, slot: int,
                  active: bool, weight: float, accumulate: bool,
                  blend: int = 0) -> None:
    """Fold one arrival into the mailbox ``mail`` ``[d_max + 1, ...]`` in
    place: ``mail[slot] = moved * w`` (put) or ``mail[slot] += moved * w``
    (accumulate), in the accumulation dtype, cast back per record. An
    inactive write (the sender did not name this rank this call) lands in
    the scratch slot ``d_max`` with a zeroed payload. ``blend`` is a
    quantization codec id applied to ``moved`` first."""
    d_max = mail.shape[0] - 1
    acc_t = _win_acc_dtype(moved.dtype)
    if blend:
        moved = _wire_codec.quantize_blend(moved, blend)
    # the weight rounded to f32, as the JAX program's weight table is; a
    # Python scalar multiplies in the tensor's dtype
    wk = float(np.float32(weight)) * float(active)
    k = slot if active else d_max
    contrib = moved.to(acc_t) * wk
    if accumulate:
        if mail.dtype == acc_t:
            mail[k].add_(contrib)
        else:
            mail[k].copy_((mail[k].to(acc_t) + contrib).to(mail.dtype))
    else:
        mail[k].copy_(contrib)


def fold_arrival(mail: torch.Tensor, host, me: int, slot: int,
                 moved: torch.Tensor, active: bool, weight: float,
                 p_sent: float, accumulate: bool, use_p: bool,
                 blend: int = 0) -> bool:
    """Rank ``me``'s receiver step for one arrival: :func:`blend_arrival`
    into its mailbox and, with associated p, the p mail ``p_sent * weight``
    added (accumulate) or set (put) at ``(me, slot)`` on the scalar host.
    Returns whether the arrival was active, i.e. whether its slot's version
    is to be bumped."""
    blend_arrival(mail, moved, slot, active, weight, accumulate, blend)
    if not active:
        return False
    if use_p:
        pc = p_sent * weight
        if accumulate:
            host.add_p_mail(me, slot, pc)
        else:
            host.set_p_mail(me, slot, pc)
    return True


def combine(self_v: torch.Tensor, mail: torch.Tensor, sw: float,
            nw: Sequence[float], reset: Sequence[int] = ()) -> torch.Tensor:
    """``sw * self + sum_k nw[k] * mail[k]`` in the accumulation dtype, cast
    to the window's dtype; then zero the mailbox slots in ``reset``."""
    acc_t = _win_acc_dtype(self_v.dtype)
    out = self_v.to(acc_t) * float(np.float32(sw))
    for k, w in enumerate(nw):
        if w != 0.0:
            out.add_(mail[k].to(acc_t) * float(np.float32(w)))
    for k in reset:
        mail[k].zero_()
    return out.to(self_v.dtype)


def p_combine(sw: float, p: float, nw: Sequence[float],
              p_mail: np.ndarray) -> float:
    """The push-sum weight's combine: ``sw * p + sum_k nw[k] * p_mail[k]``
    in f64, with the mailbox weights rounded to f32 as the data's are."""
    nw64 = np.asarray(nw, np.float32).astype(np.float64)
    return float(sw) * p + float(np.sum(nw64 * np.asarray(p_mail,
                                                          np.float64)))


class _OnceWork:
    """A ``Work`` waited on at most once (a gloo point-to-point ``Work``
    waited on twice blocks for a second message), shared by the handle's
    waiter and the window's own settle."""

    __slots__ = ("_w", "_lock", "_done")

    def __init__(self, w) -> None:
        self._w = w
        self._lock = threading.Lock()
        self._done = False

    def wait(self):
        with self._lock:
            if not self._done:
                self._w.wait()
                self._done = True
        return True

    def is_completed(self) -> bool:
        return self._done or self._w.is_completed()


class Window:
    """Mailbox state for one named window of this process's rank.

    Edges are frozen at creation (``set_topology`` refuses while windows
    exist). ``mail_dtype`` is the window dtype for float windows and f32
    for integer ones (weighted contributions stay exact until
    ``win_update`` casts back).
    """

    def __init__(self, name: str, tensor: torch.Tensor,
                 zero_init: bool) -> None:
        st = _global_state()
        self.name = name
        self.size = st.size
        self.rank = st.rank
        self.layout = _GraphLayout(st.topology, st.size)
        self.in_neighbors = self.layout.in_nbrs
        self.out_neighbors = self.layout.out_nbrs
        d = self.layout.d_max
        tensor = tensor.detach()
        self.dtype = tensor.dtype
        self.mail_dtype = _win_mail_dtype(self.dtype)
        self.row_shape = tuple(tensor.shape)
        self.device = tensor.device
        policy = getattr(st, "win_plane", None) or _plane_policy()
        self.hosted = _hosted_mode_enabled(policy)
        # wire codec, resolved once per window; per-edge overrides from
        # the ``;src>dst=spec`` grammar and the tuner's set_edge_codec
        self.codec, _edge_over = _wire_codec.resolve_edge_spec(
            knob_env("BFT_WIN_CODEC"))
        self._edge_codec: Dict[Tuple[int, int],
                               Optional[_wire_codec.WireCodec]] = \
            dict(_edge_over)
        # sharded rotation: deposits carry the active shard so a drifted
        # owner never folds another shard's coordinates
        self.shard_factor = 1
        self.active_shard = -1
        # error feedback: residual rows and the put-mode CHOCO estimate,
        # per owned source (window codec) and per overridden edge
        self._ef_rows: Dict[int, np.ndarray] = {}
        self._ef_ref: Dict[int, np.ndarray] = {}
        self._ef_edge_rows: Dict[Tuple[int, int], np.ndarray] = {}
        self._ef_edge_ref: Dict[Tuple[int, int], np.ndarray] = {}
        self.owned = [st.rank]
        if _cp.active():
            self.host = _ControlPlaneWinHost(name, st.size,
                                             self.layout.d_max, self.owned)
        else:
            self.host = _LocalWinHost(name, st.size, self.layout.d_max,
                                      st.rank)
        self._pending: List = []  # collective exchanges not yet blended
        if self.hosted:
            # discard deposit records a crashed predecessor window of the
            # same name left on the server
            cl = _cp.client()
            for r in self.owned:
                for k in range(d):
                    while cl.take_bytes(self._dep_key(r, k)):
                        pass
            me = self.owned[0]
            self._rows = {me: np.array(to_host(tensor),
                                       host_dtype(self.dtype))}
            acc_t = self._acc_np()
            mail_t = host_dtype(self.mail_dtype)
            if self.codec is not None and self.codec.error_feedback:
                self._ef_ref = {
                    r: (np.zeros(self.row_shape, acc_t) if zero_init
                        else cast(self._rows[r], acc_t).copy())
                    for r in self.owned}
            for (_s, _d), _c in self._edge_codec.items():
                if _c is not None and _c.error_feedback and _s in \
                        self.owned:
                    self._ef_edge_ref[(_s, _d)] = (
                        np.zeros(self.row_shape, acc_t) if zero_init
                        else cast(self._rows[_s], acc_t).copy())
            if zero_init:
                self._mail_rows = {
                    r: np.zeros((d,) + self.row_shape, mail_t)
                    for r in self.owned}
            else:
                self._mail_rows = {
                    r: np.broadcast_to(
                        cast(self._rows[r], mail_t)[None],
                        (d,) + self.row_shape).copy()
                    for r in self.owned}
            self._publish_selves(self.owned)
            # creation is aligned across controllers (like MPI_Win_create)
            # except for a quarantined rejoiner, whose survivors never
            # arrive at a creation barrier
            from ..runtime.heartbeat import quarantine_pending

            if not quarantine_pending():
                self.host.flush()
        else:
            self._self_value = tensor.clone()
            shape = (d + 1,) + self.row_shape
            if zero_init:
                self.mail = torch.zeros(shape, dtype=self.mail_dtype,
                                        device=self.device)
            else:
                # neighbour buffers start as a copy of the local tensor
                self.mail = tensor.to(self.mail_dtype).unsqueeze(0).expand(
                    shape).clone()
        # serializes the read-modify-write of the window's rows and mailbox
        self.state_mu = threading.RLock()
        # deposit sequence of the tagged wire (each mailbox key has one
        # writing process and state_mu serializes its deposits)
        self._dep_seq = 0

    def _acc_np(self) -> np.dtype:
        return host_dtype(_win_acc_dtype(self.mail_dtype))

    # -- sharded rotation ---------------------------------------------------

    def bind_shard(self, factor: int, start: int = 0) -> None:
        """Declare this window's rows as rotating shard rows."""
        self.shard_factor = max(1, int(factor))
        self.active_shard = int(start) if self.shard_factor > 1 else -1
        _metrics.gauge("win.shard_factor").set(float(self.shard_factor))

    def set_active_shard(self, shard: int) -> None:
        """Advance the rotation (serialized against the drain)."""
        with self.state_mu:
            self.active_shard = int(shard) % self.shard_factor

    # -- self_value ---------------------------------------------------------

    @property
    def self_value(self) -> torch.Tensor:
        """This rank's window tensor, on the window's device."""
        if not self.hosted:
            return self._self_value
        return from_host(self._rows[self.owned[0]], self.dtype, self.device)

    @self_value.setter
    def self_value(self, value) -> None:
        if not self.hosted:
            self._self_value = value
            return
        with self.state_mu:
            me = self.owned[0]
            self._rows[me] = np.array(cast(to_host(value),
                                           host_dtype(self.dtype)))
            self._publish_selves(self.owned)

    # -- hosted-plane internals ----------------------------------------------

    def _self_key(self, rank: int) -> str:
        return f"w.{self.name}.self.{rank}"

    def _dep_key(self, dst: int, k: int) -> str:
        return f"w.{self.name}.dep.{dst}.{k}"

    def _sidx_key(self, rank: int) -> str:
        return f"w.{self.name}.sidx.{rank}"

    def read_published_shard(self, rank: int):
        """``(row, shard_index)`` of a rank's published tensor on a sharded
        window (shard_index None when unsharded or never published)."""
        sidx = None
        if self.shard_factor > 1:
            try:
                v = int(_cp.client().get(self._sidx_key(rank)))
            except (OSError, RuntimeError):
                v = 0
            sidx = (v - 1) if v > 0 else None
        return self.read_published_row(rank), sidx

    def _publish_selves(self, ranks) -> None:
        """Publish the owned rows (the exposed window ``win_get`` reads) in
        one pipelined round-trip: raw rows as uint8 views, or, under a
        codec, its state codec's payload behind a 4-byte magic + codec id
        header (:meth:`_parse_published`)."""
        ranks = list(ranks)
        if not ranks:
            return
        if self.shard_factor > 1:
            _cp.client().put_many(
                [self._sidx_key(r) for r in ranks],
                [self.active_shard + 1] * len(ranks))
        pub = _wire_codec.state_codec_for(self.codec)
        if pub is not None:
            blobs = []
            raw_b = wire_b = 0
            for r in ranks:
                enc = pub.encode(self._rows[r])
                blob = np.empty(_PUB_HDR + enc.nbytes, np.uint8)
                blob[:_PUB_HDR] = np.frombuffer(
                    struct.pack("<IBBH", _PUB_MAGIC, pub.cid, 0, 0),
                    np.uint8)
                blob[_PUB_HDR:] = enc
                blobs.append(blob)
                raw_b += self._rows[r].nbytes
                wire_b += blob.nbytes
            _metrics.counter("win.codec.raw_bytes").inc(raw_b)
            _metrics.counter("win.codec.wire_bytes").inc(wire_b)
            _cp.client().put_bytes_many(
                [self._self_key(r) for r in ranks], blobs)
            return
        _cp.client().put_bytes_many(
            [self._self_key(r) for r in ranks],
            [np.ascontiguousarray(self._rows[r]).reshape(-1).view(np.uint8)
             for r in ranks])

    def _parse_published(self, rank: int, buf) -> np.ndarray:
        """Published payload -> row: raw wire-dtype bytes, or a
        magic-prefixed state-codec payload (the codec id comes from the
        payload)."""
        ht = host_dtype(self.dtype)
        expect = int(np.prod(self.row_shape, dtype=np.int64)) * ht.itemsize
        n = len(buf)
        if n == expect:
            return np.frombuffer(buf, ht).reshape(self.row_shape)
        if n > _PUB_HDR:
            magic, cid = struct.unpack_from("<IB", buf, 0)
            if magic == _PUB_MAGIC:
                count = int(np.prod(self.row_shape, dtype=np.int64))
                flat = _wire_codec.by_id(cid).decode(
                    np.frombuffer(buf, np.uint8)[_PUB_HDR:], ht, count)
                return flat.reshape(self.row_shape)
        raise RuntimeError(
            f"window '{self.name}': published tensor for rank "
            f"{rank} has {n} bytes, expected {expect} (raw) or an "
            "encoded-state payload")

    def _read_remote_selves(self, ranks) -> List[np.ndarray]:
        """Batched read of published tensors: one pipelined round-trip."""
        ranks = list(ranks)
        if not ranks:
            return []
        raws = _cp.client().get_bytes_many(
            [self._self_key(r) for r in ranks])
        return [self._parse_published(rank, raw)
                for rank, raw in zip(ranks, raws)]

    def _read_remote_self_view(self, rank: int):
        """``(row, owner)``: one published row over the native reply
        (striped for large rows); the caller closes ``owner``."""
        view, owner = _cp.client().get_bytes_view(self._self_key(rank))
        return self._parse_published(rank, view), owner

    def _fold_record(self, dst: int, k: int, mode: int,
                     contrib: np.ndarray) -> None:
        """Fold one contribution into an owned mailbox slot: accumulate in
        the acc dtype and cast back per record (one in-place add when the
        mail dtype is the acc dtype); a put overwrites."""
        acc_t = self._acc_np()
        slot = self._mail_rows[dst][k]
        if mode == _DEP_ACC:
            if slot.dtype == acc_t:
                np.add(slot, cast(contrib, acc_t), out=slot)
            else:
                slot[...] = cast(cast(slot, acc_t) + cast(contrib, acc_t),
                                 slot.dtype)
        else:
            np.copyto(slot, cast(contrib, slot.dtype))

    def ef_residual(self, src: int) -> np.ndarray:
        """The error-feedback residual row of owned source ``src`` (zeros
        until the first compressed send), in the acc dtype."""
        r = self._ef_rows.get(src)
        if r is None:
            r = self._ef_rows[src] = np.zeros(self.row_shape, self._acc_np())
        return r

    def ef_residual_norm(self) -> float:
        """L2 norm over every residual (the ``win.codec.residual_norm``
        gauge's source)."""
        if not self._ef_rows and not self._ef_edge_rows:
            return 0.0
        return float(np.sqrt(
            sum(float(np.sum(np.square(r, dtype=np.float64)))
                for r in self._ef_rows.values())
            + sum(float(np.sum(np.square(r, dtype=np.float64)))
                  for r in self._ef_edge_rows.values())))

    def ef_edge_residual_norm(self, src: int, dst: int) -> float:
        """L2 norm of one overridden edge's own residual."""
        r = self._ef_edge_rows.get((int(src), int(dst)))
        if r is None:
            return 0.0
        return float(np.sqrt(np.sum(np.square(r, dtype=np.float64))))

    def codec_for(self, src: int, dst: int):
        """Effective wire codec of edge ``src -> dst``."""
        try:
            return self._edge_codec[(int(src), int(dst))]
        except KeyError:
            return self.codec

    def set_edge_codec(self, src: int, dst: int, spec) -> bool:
        """Switch one edge's wire codec at run time (the tuner's codec
        lever). To an error-feedback codec in put mode the next send
        REBASES (a full row through the state codec, folded as a put);
        away from error feedback the put-mode reference is dropped while an
        accumulate residual is kept and folded into the next send. Returns
        True when the effective codec changed."""
        edge = (int(src), int(dst))
        new = _wire_codec.resolve(spec) if isinstance(spec, str) or \
            spec is None else spec
        cur = self.codec_for(*edge)

        def _key(c):
            return None if c is None else (c.cid, getattr(c, "frac", None))

        if _key(new) == _key(cur):
            return False
        if _key(new) == _key(self.codec):
            self._edge_codec.pop(edge, None)
        else:
            self._edge_codec[edge] = new
        if new is None or not new.error_feedback:
            self._ef_edge_ref.pop(edge, None)
        _metrics.counter("win.codec.edge_switches").inc()
        return True

    def _edge_residual(self, edge: Tuple[int, int]) -> np.ndarray:
        r = self._ef_edge_rows.get(edge)
        if r is None:
            r = self._ef_edge_rows[edge] = np.zeros(self.row_shape,
                                                    self._acc_np())
        return r

    def _edge_raw_base(self, edge: Tuple[int, int], x: np.ndarray,
                       mode: int) -> np.ndarray:
        """Send base of a raw override edge: an accumulate folds residual
        mass an earlier EF codec left; a put supersedes it."""
        e = self._ef_edge_rows.pop(edge, None)
        if mode == _DEP_ACC and e is not None:
            return x + e
        return x

    def _encode_edge(self, edge: Tuple[int, int], x: np.ndarray, wire_t,
                     mode: int):
        """Per-edge :meth:`_encode_row` of an overridden edge:
        ``(payload, estimate, fold_mode, wire_codec)``; a rebase send ships
        through the codec's state fallback."""
        codec = self._edge_codec[edge]
        acc_t = self._acc_np()
        fold_mode = mode
        ref = None
        if codec.error_feedback and mode == _DEP_PUT:
            ref = self._ef_edge_ref.get(edge)
            if ref is None:
                wire = _wire_codec.state_codec_for(codec)
                raw = np.ascontiguousarray(cast(x, wire_t)).reshape(-1)
                payload = wire.encode(raw)
                est = cast(wire.decode(payload, wire_t, raw.size),
                           acc_t).reshape(self.row_shape)
                self._ef_edge_ref[edge] = est
                self._ef_edge_rows[edge] = x - est
                _metrics.counter("win.codec.edge_rebase").inc()
                _metrics.counter("win.codec.raw_bytes").inc(raw.nbytes)
                _metrics.counter("win.codec.wire_bytes").inc(payload.nbytes)
                return payload, est, _DEP_PUT, wire
            base = x - ref
            fold_mode = _DEP_ACC
        elif codec.error_feedback:
            base = x + self._edge_residual(edge)
        else:
            # a non-EF codec still folds a pre-switch residual into an
            # accumulate (numerator mass carries across the switch)
            e = self._ef_edge_rows.get(edge) if mode == _DEP_ACC else None
            base = x if e is None else x + e
        raw = np.ascontiguousarray(cast(base, wire_t)).reshape(-1)
        payload = codec.encode(raw)
        est = cast(codec.decode(payload, wire_t, raw.size),
                   acc_t).reshape(self.row_shape)
        if codec.error_feedback:
            if mode == _DEP_PUT:
                self._ef_edge_ref[edge] = ref + est
                self._ef_edge_rows[edge] = x - self._ef_edge_ref[edge]
            else:
                self._ef_edge_rows[edge] = base - est
            _metrics.gauge("win.codec.residual_norm").set(
                self.ef_residual_norm())
        elif mode == _DEP_ACC and edge in self._ef_edge_rows:
            self._ef_edge_rows[edge] = base - est
        _metrics.counter("win.codec.raw_bytes").inc(raw.nbytes)
        _metrics.counter("win.codec.wire_bytes").inc(payload.nbytes)
        _metrics.gauge("win.codec.ratio").set(
            raw.nbytes / payload.nbytes if payload.nbytes else 0.0)
        return payload, est, fold_mode, codec

    def _encode_row(self, src: int, x: np.ndarray, wire_t, mode: int):
        """Encode one source row for the wire, once per op:
        ``(payload, estimate, fold_mode)``. The payload feeds every
        out-edge on the window codec (weights move receiver-side) and the
        decoded estimate feeds the local folds. Error-feedback codecs: a
        put ships ``C(x - x_hat)`` against the sender-tracked estimate and
        folds additively (CHOCO-SGD); an accumulate ships ``C(x + e)`` and
        keeps ``e = (x + e) - est`` (EF-SGD)."""
        codec = self.codec
        acc_t = self._acc_np()
        fold_mode = mode
        if codec.error_feedback and mode == _DEP_PUT:
            ref = self._ef_ref.get(src)
            if ref is None:
                ref = self._ef_ref[src] = np.zeros(self.row_shape, acc_t)
            base = x - ref
            fold_mode = _DEP_ACC
        elif codec.error_feedback:
            base = x + self.ef_residual(src)
        else:
            base = x
        raw = np.ascontiguousarray(cast(base, wire_t)).reshape(-1)
        payload = codec.encode(raw)
        est = cast(codec.decode(payload, wire_t, raw.size),
                   acc_t).reshape(self.row_shape)
        if codec.error_feedback:
            if mode == _DEP_PUT:
                self._ef_ref[src] = ref + est
                self._ef_rows[src] = x - self._ef_ref[src]  # unsent gap
            else:
                self._ef_rows[src] = base - est
            _metrics.gauge("win.codec.residual_norm").set(
                self.ef_residual_norm())
        _metrics.counter("win.codec.raw_bytes").inc(raw.nbytes)
        _metrics.counter("win.codec.wire_bytes").inc(payload.nbytes)
        _metrics.gauge("win.codec.ratio").set(
            raw.nbytes / payload.nbytes if payload.nbytes else 0.0)
        return payload, est, fold_mode

    def _start_deposit(self, pair, rec,
                       expect: int) -> Optional["_PendingDeposit"]:
        """Parse a deposit's header record into reassembly state. A raw
        put streams straight into the mailbox slot (wire dtype == mail
        dtype); accumulates, codec deposits and shard-drift discards stage
        in a buffer. ``expect`` is the raw payload's byte count; a codec
        deposit's comes from its extension header."""
        seq = int.from_bytes(rec[:_DEP_TAG], "little") >> 24
        raw_mode, has_p, pc, nchunks = struct.unpack_from(
            "<BBdI", rec, _DEP_TAG)
        codec_id = raw_mode >> _DEP_CODEC_SHIFT
        mode = raw_mode & _DEP_MODE_MASK
        wt = 1.0
        hdr_end = _DEP_TAG + _DEP_HDR
        if codec_id:
            wt, expect = struct.unpack_from("<dQ", rec, hdr_end)
            hdr_end += _DEP_EXT
        shard = -1
        if raw_mode & _DEP_SHARD_FLAG:
            shard, = struct.unpack_from("<i", rec, hdr_end)
            hdr_end += _DEP_SHARD_EXT
        # rotation drift: a deposit of another shard than this owner's
        # active one is dropped (accumulate p mass still folds)
        discard = shard >= 0 and shard != self.active_shard
        if codec_id or discard or mode != _DEP_PUT:
            staging = np.empty(expect, np.uint8)
            target = staging
        else:
            target = self._mail_rows[pair[0]][pair[1]].reshape(-1).view(
                np.uint8)
            staging = None
        pend = _PendingDeposit(mode, has_p, pc, seq, nchunks, target,
                               staging, codec_id=codec_id, wt=wt,
                               expect=int(expect), shard=shard,
                               discard=discard)
        # compact single-record form: a header carrying payload inline
        body = rec[hdr_end:]
        if len(body):
            pend.target[:len(body)] = np.frombuffer(body, np.uint8)
            pend.hdr_len = pend.got = len(body)
        return pend

    def _place_chunk(self, pair, pend: "_PendingDeposit", idx: int,
                     body) -> None:
        """Place one continuation chunk at its offset: every chunk but the
        last is the sender's chunk size (learned from the first non-last
        one to arrive), the last anchors to the tail, so out-of-order
        arrivals reassemble exactly."""
        expect = pend.expect
        blen = len(body)
        off = -1
        bad = idx < 1 or idx > pend.nchunks or idx in pend.seen
        if not bad:
            if idx == pend.nchunks:
                off = expect - blen
            else:
                if pend.cap is None:
                    pend.cap = blen
                off = pend.hdr_len + (idx - 1) * pend.cap
                bad = blen != pend.cap
        if bad or off < 0 or off + blen > expect:
            raise RuntimeError(
                f"window '{self.name}': deposit chunk {idx} for (rank, "
                f"slot) {pair} of {blen} bytes does not fit the expected "
                f"{expect}-byte payload — wire corruption or a mismatched "
                "window shape across controllers")
        if blen:
            pend.target[off:off + blen] = np.frombuffer(body, np.uint8)
            pend.got += blen
        pend.seen.add(idx)

    def _finish_deposit(self, pair, pend: "_PendingDeposit") -> None:
        """Fold one complete deposit (the origin's flow arrow ends here)."""
        timeline_flow_finish(_FLOW_DEPOSIT, pend.seq)
        _metrics.counter("win.deposits_drained").inc()
        fl = _flight.recorder()
        fl.rec(_flight.FLOW_F,
               fl.intern(f"drain.{(pend.seq >> 32) & 0x7F}"),
               pend.got, pend.seq)
        if pend.discard:
            # put drops the whole (value, p) pair; accumulate keeps the
            # exact p mass so push-sum conservation survives drift
            _metrics.counter("win.shard_stale_drops").inc()
            if pend.has_p and pend.mode == _DEP_ACC:
                self.host.add_p_mail(pair[0], pair[1], pend.pc)
            return
        if pend.codec_id:
            wire_t = _win_wire_dtype(self.mail_dtype)
            acc_t = self._acc_np()
            n = int(np.prod(self.row_shape, dtype=np.int64))
            codec_obj = _wire_codec.by_id(pend.codec_id)
            # error-feedback put deposits are CHOCO deltas: integrate
            fold_mode = _DEP_ACC if (codec_obj.error_feedback
                                     and pend.mode == _DEP_PUT) \
                else pend.mode
            _metrics.counter("win.codec.wire_bytes_in").inc(pend.got)
            slot = self._mail_rows[pair[0]][pair[1]]
            with fl.span("win.fold", a=pend.got):
                if fold_mode == _DEP_PUT and slot.dtype == np.float32:
                    # decode straight into the slot, the edge weight folded
                    # into the per-block scales
                    codec_obj.decode(pend.staging, np.float32, n,
                                     scale_mul=pend.wt,
                                     out=slot.reshape(-1))
                else:
                    flat = codec_obj.decode(pend.staging, wire_t, n,
                                            scale_mul=pend.wt)
                    contrib = cast(flat, acc_t).reshape(self.row_shape)
                    self._fold_record(pair[0], pair[1], fold_mode, contrib)
        elif pend.mode == _DEP_ACC:
            wire_t = _win_wire_dtype(self.mail_dtype)
            contrib = pend.staging.view(wire_t).reshape(self.row_shape)
            with fl.span("win.fold", a=pend.got):
                self._fold_record(pair[0], pair[1], _DEP_ACC, contrib)
        if pend.has_p:
            if pend.mode == _DEP_ACC:
                self.host.add_p_mail(pair[0], pair[1], pend.pc)
            else:
                self.host.set_p_mail(pair[0], pair[1], pend.pc)

    def _drain_deposits(self, strict: bool = False) -> None:
        """Take pending server deposits for every owned (rank, slot) and
        fold them in deposit order (under ``state_mu``).

        One pipelined multi-take per round covers every mailbox; after a
        round that produced records the next take runs on a prefetch
        thread while this one folds. Chunks place at their tag-index
        offset (striped origins arrive out of order); pendings are keyed
        per (mailbox, seq). Orphans — the tail a win_free/win_fence clear
        raced past — are a chunk with no drained header, or a pending
        superseded by a newer counter in its own origin's namespace. A
        partial deposit older than ``BFT_WIN_DRAIN_TIMEOUT`` raises.

        ``strict`` (the caller holds the rank mutexes and
        ``BFT_WIN_STRICT=1``): every slot that received a deposit must show
        version >= 1, since origins bump before depositing inside their
        mutex-held region."""
        strict = strict and bool(knob_env("BFT_WIN_STRICT"))
        cl = _cp.client()
        pairs = [(r, k) for r in self.owned
                 for k in range(self.layout.d_max)]
        expect = int(np.prod(self.row_shape, dtype=np.int64)) * \
            _win_wire_dtype(self.mail_dtype).itemsize
        touched: set = set()
        partial: Dict[Tuple[int, int], Dict[int, _PendingDeposit]] = {}
        orphans = 0
        drain_timeout = float(knob_env("BFT_WIN_DRAIN_TIMEOUT"))

        def sweep(poll_pairs, pooled=True):
            poll_names = [self._dep_key(r, k) for r, k in poll_pairs]
            return (_Prefetch(lambda: cl.take_bytes_many_views(
                        poll_names, pooled=pooled)),
                    poll_pairs)

        drained_records = 0
        drained_bytes = 0
        _fl = _flight.recorder()
        _fl.begin("win.drain")
        try:
            fetch, fetch_pairs = sweep(pairs)
            while True:
                batches, owner = fetch.result()
                cur_pairs, fetch = fetch_pairs, None
                got = any(batches)
                if got:
                    round_bytes = sum(len(r) for recs in batches
                                      for r in recs)
                    drained_records += sum(len(recs) for recs in batches)
                    drained_bytes += round_bytes
                    # stream the next sweep while these records fold; pool
                    # it only after a round that hauled bulk bytes
                    fetch, fetch_pairs = sweep(
                        pairs,
                        pooled=round_bytes >= getattr(
                            cl, "_stripe_min", 1 << 22))
                try:
                    for pair, records in zip(cur_pairs, batches):
                        if not records:
                            continue
                        touched.add(pair)
                        pend_map = partial.get(pair)
                        if pend_map is None:
                            pend_map = partial[pair] = {}
                        # newest deposit counter per origin this round
                        ns_max: Dict[int, int] = {}
                        for rec in records:
                            tag = int.from_bytes(rec[:_DEP_TAG], "little")
                            seq, idx = tag >> 24, tag & 0xFFFFFF
                            ns, ctr = seq >> 32, seq & 0xFFFFFFFF
                            prev = ns_max.get(ns)
                            if prev is None or _seq_newer(ctr, prev):
                                ns_max[ns] = ctr
                            if idx == 0:
                                if seq in pend_map:
                                    orphans += 1  # duplicate header
                                pend = pend_map[seq] = self._start_deposit(
                                    pair, rec, expect)
                            else:
                                pend = pend_map.get(seq)
                                if pend is None:
                                    # a chunk whose header a clear ate
                                    orphans += 1
                                    continue
                                self._place_chunk(pair, pend, idx,
                                                  rec[_DEP_TAG:])
                            if pend.got == pend.expect:
                                self._finish_deposit(pair, pend)
                                del pend_map[seq]
                        # a pending superseded by a newer counter of its
                        # own origin can never complete
                        for seq_o in list(pend_map):
                            m = ns_max.get(seq_o >> 32)
                            if m is not None and _seq_newer(
                                    m, seq_o & 0xFFFFFFFF):
                                del pend_map[seq_o]
                                orphans += 1
                        if not pend_map:
                            del partial[pair]
                finally:
                    owner.close()
                if not partial:
                    if not got:
                        break
                    continue
                # per-partial deadline, anchored when that deposit appeared
                now = time.monotonic()
                stale = sorted({p for p, pmap in partial.items()
                                for pend in pmap.values()
                                if now - pend.t0 > drain_timeout})
                if stale:
                    raise RuntimeError(
                        f"window '{self.name}': deposit chunk sequence for "
                        f"(rank, slot) {stale} never completed within "
                        f"{drain_timeout:.0f}s — the origin died "
                        "mid-deposit (BFT_WIN_DRAIN_TIMEOUT)")
                if not got:
                    # poll only the keys that hold partial deposits
                    time.sleep(0.005)
                    fetch, fetch_pairs = sweep(sorted(partial),
                                               pooled=False)
        finally:
            _fl.end("win.drain", a=drained_bytes)
        if drained_records:
            _metrics.counter("win.drain_records").inc(drained_records)
            _metrics.counter("win.drain_bytes").inc(drained_bytes)
            timeline_counter("win.drained_records", drained_records)
        if orphans:
            _metrics.counter("win.drain_orphans").inc(orphans)
            logger.debug(
                "window '%s': discarded %d orphaned deposit chunk(s) left "
                "by a concurrent clear", self.name, orphans)
        if strict and touched:
            stale = sorted(touched)
            vers = self.host.get_versions(stale)
            bad = [pair for pair, v in zip(stale, vers) if v == 0]
            if bad:
                raise RuntimeError(
                    f"window '{self.name}': deposits consumed at version 0 "
                    f"for (rank, slot) {bad} — an origin wrote without "
                    "require_mutex while this update held the rank mutex; "
                    "strict window consistency requires every participant "
                    "to pass require_mutex=True")

    def close(self, aligned: bool = True) -> None:
        """Release hosted-plane server state (win_free): barrier, discard
        this process's pending deposits and published rows, barrier.
        ``aligned=False`` (shutdown) skips the barriers."""
        if not self.hosted:
            self._pending.clear()
            return
        if aligned:
            self.host.flush()
        cl = _cp.client()
        names = [self._dep_key(r, k) for r in self.owned
                 for k in range(self.layout.d_max)]
        while any(cl.take_bytes_many(names)):
            pass
        cl.put_bytes_many([self._self_key(r) for r in self.owned],
                          [b""] * len(self.owned))
        if aligned:
            self.host.flush()

    # -- elastic rejoin support (hosted plane) ------------------------------

    def read_published_row(self, rank: int):
        """One rank's published row, or None when absent or mis-sized."""
        raw = _cp.client().get_bytes(self._self_key(rank))
        try:
            return self._parse_published(rank, raw).copy()
        except RuntimeError:
            return None

    def install_row(self, rank: int, row) -> None:
        """Owner-write one OWNED rank's row and publish it."""
        if rank not in self.owned:
            raise ValueError(f"install_row: rank {rank} is not owned here")
        with self.state_mu:
            self._rows[rank] = np.array(cast(to_host(row),
                                             host_dtype(self.dtype)))
            self._publish_selves([rank])

    # -- the collective plane -----------------------------------------------

    def _blend_code(self) -> int:
        c = self.codec
        return c.cid if c is not None and c.cid in (
            _wire_codec.CODEC_INT8, _wire_codec.CODEC_FP8) else 0

    def _settle(self) -> None:
        """Blend every exchange started on this window, in issue order."""
        with self.state_mu:
            while self._pending:
                self._pending.pop(0)()


# Deposit record (hosted plane wire format):
#   i64 tag | u8 mode | u8 has_p | f64 p_contrib | u32 nchunks | payload
# followed by nchunks-1 ``i64 tag | raw chunk`` continuation records on the
# same mailbox key. The tag, ``seq << 24 | record_index``, is given to the
# server per record and prefixed server-side, so the drain tells a header
# (index 0) from a continuation structurally. The payload is the window's
# own float dtype (f32 for integer windows), chunked at
# BFT_MAX_WIN_SENT_LENGTH bytes. A codec id rides the mode byte's high
# nibble with an ``f64 weight | u64 encoded bytes`` extension; bit 3 flags
# an ``i32`` shard index after it.
_DEP_PUT = 0
_DEP_ACC = 1
_DEP_HDR = struct.calcsize("<BBdI")
_DEP_TAG = 8  # server-prefixed i64 tag bytes per stored record
_DEFAULT_MAX_SENT = 16 << 20
_DEP_MODE_MASK = 0x07
_DEP_CODEC_SHIFT = 4
_DEP_EXT = struct.calcsize("<dQ")
_DEP_SHARD_FLAG = 0x08
_DEP_SHARD_EXT = struct.calcsize("<i")
# published-row state-codec framing: u32 magic | u8 codec id | 3 reserved
_PUB_MAGIC = 0x43575642  # "BVWC"
_PUB_HDR = struct.calcsize("<IBBH")


def _deposit_tags(seq: int, nrec: int, origin: int = 0) -> List[int]:
    """Per-record int64 tags of one deposit: ``seq << 24 | index``, the
    39-bit seq a 32-bit per-origin counter under a 7-bit origin id."""
    base = (((origin & 0x7F) << 32) | (seq & 0xFFFFFFFF)) << 24
    return [base | (i & 0xFFFFFF) for i in range(nrec)]


def _seq_newer(a: int, b: int) -> bool:
    """Is 32-bit counter ``a`` strictly newer than ``b`` (wrap-safe)?"""
    return a != b and ((a - b) & 0xFFFFFFFF) < (1 << 31)


class _Prefetch:
    """Run ``fn()`` on a worker thread; ``result()`` joins and re-raises."""

    __slots__ = ("_t", "_r", "_e")

    def __init__(self, fn) -> None:
        self._r = self._e = None

        def run():
            try:
                self._r = fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised in result
                self._e = exc

        self._t = threading.Thread(target=run, name="bft-win-prefetch",
                                   daemon=True)
        self._t.start()

    def result(self):
        self._t.join()
        if self._e is not None:
            raise self._e
        return self._r


class _PendingDeposit:
    """Reassembly state of one in-flight deposit on one mailbox key."""

    __slots__ = ("mode", "has_p", "pc", "seq", "nchunks", "cap", "hdr_len",
                 "got", "seen", "staging", "target", "t0", "codec_id", "wt",
                 "expect", "shard", "discard")

    def __init__(self, mode: int, has_p: int, pc: float, seq: int,
                 nchunks: int, target: np.ndarray, staging,
                 codec_id: int = 0, wt: float = 1.0,
                 expect: int = 0, shard: int = -1,
                 discard: bool = False) -> None:
        self.mode = mode
        self.has_p = has_p
        self.pc = pc
        self.seq = seq
        self.nchunks = nchunks
        self.cap = None      # sender chunk size, learned from a non-last
        self.hdr_len = 0     # bytes carried inline by the header record
        self.got = 0
        self.seen: set = set()
        self.target = target    # flat uint8 view, len == expected bytes
        self.staging = staging  # staging array (None for a raw put)
        self.codec_id = codec_id
        self.wt = wt            # receiver-side edge weight (codec wire)
        self.expect = expect
        self.shard = shard
        self.discard = discard
        self.t0 = time.monotonic()


_sent_clamp_warned = False


def _max_sent_bytes() -> int:
    global _sent_clamp_warned
    v = int(knob_env("BFT_MAX_WIN_SENT_LENGTH"))
    if v < (1 << 16) and not _sent_clamp_warned:
        # the reference counted ELEMENTS; a sub-64 KiB value is most likely
        # a migrated element count
        _sent_clamp_warned = True
        logger.warning(
            "BFT_MAX_WIN_SENT_LENGTH=%d is below the 64 KiB floor and is "
            "clamped; the knob counts BYTES per wire chunk, not elements", v)
    return max(1 << 16, v)


def _pack_deposit(mode: int, has_p: int, pc: float, payload,
                  codec_id: int = 0, wt: float = 1.0,
                  shard: int = -1) -> List:
    """One deposit's wire records: a header record, then payload chunks of
    at most ``BFT_MAX_WIN_SENT_LENGTH`` bytes (zero-copy memoryview slices
    of ``payload``). ``codec_id`` adds the extension header (weight and
    encoded byte count); ``shard >= 0`` the shard flag and index."""
    cap = _max_sent_bytes()
    if isinstance(payload, np.ndarray):
        payload = np.ascontiguousarray(payload).reshape(-1).view(np.uint8)
    mv = memoryview(payload).cast("B")
    chunks = [mv[i:i + cap] for i in range(0, mv.nbytes, cap)]
    mode_byte = mode | (codec_id << _DEP_CODEC_SHIFT)
    if shard >= 0:
        mode_byte |= _DEP_SHARD_FLAG
    hdr = struct.pack("<BBdI", mode_byte, has_p, pc, len(chunks))
    if codec_id:
        hdr += struct.pack("<dQ", float(wt), mv.nbytes)
    if shard >= 0:
        hdr += struct.pack("<i", int(shard))
    return [hdr, *chunks]


def _blen(b) -> int:
    return len(b) if isinstance(b, (bytes, bytearray)) else \
        memoryview(b).nbytes


def _precheck_mailbox_cap(win: Window, dep_names, dep_blobs,
                          dep_edge_of) -> set:
    """Edges whose deposits would overflow the server's mailbox byte cap,
    checked per deposit before any record ships (a rejection mid-sequence
    would leave a torn deposit). The cap is the one the serving process
    published. A single deposit above it can never land: that raises as a
    configuration error."""
    cap = _cp.mailbox_cap_bytes()
    if cap <= 0:
        return set()
    sizes: Dict[str, int] = {}
    edge_of: Dict[str, Tuple[int, int, int]] = {}
    for nm, blob, edge in zip(dep_names, dep_blobs, dep_edge_of):
        sizes[nm] = sizes.get(nm, 0) + _blen(blob) + _DEP_TAG
        edge_of[nm] = edge
    too_big = {nm: sizes[nm] for nm in sizes if sizes[nm] > cap}
    if too_big:
        worst = max(too_big.values())
        raise ValueError(
            f"window '{win.name}': a single deposit of {worst} bytes "
            f"exceeds the {cap}-byte mailbox cap for edges "
            f"{sorted(edge_of[nm] for nm in too_big)} — raise "
            "BFT_CP_MAILBOX_MAX_MB (it must exceed one full window row) "
            "or split the window tensor into smaller leaves")
    keys = sorted(sizes)
    pending = dict(zip(keys, _cp.client().box_bytes_many(keys)))
    return {edge_of[nm] for nm in keys
            if pending[nm] + sizes[nm] > cap}


def _get_window(name: str) -> Window:
    st = _global_state()
    st.check_initialized()
    win = st.windows.get(name)
    if win is None:
        raise ValueError(f"window '{name}' does not exist; call win_create "
                         "first")
    return win


def _row_weights(weights: Optional[Weights], me: int,
                 neighbors: Dict[int, List[int]], default: float,
                 what: str) -> Dict[int, float]:
    """This rank's ``{peer: w}`` from None (every neighbour at
    ``default``), a float (every neighbour at it), a flat ``{peer: w}``
    (the entries naming this rank's neighbours; a key nobody's neighbour
    is a typo and raises) or the nested ``{rank: {peer: w}}`` form."""
    mine = neighbors[me]
    if weights is None:
        return {p: default for p in mine}
    if not isinstance(weights, dict):
        return {p: float(weights) for p in mine}
    first = next(iter(weights.values()), None)
    if isinstance(first, dict):
        row = dict(weights.get(me, {}))
        extra = set(row) - set(mine)
        if extra:
            raise ValueError(f"{what} for rank {me} references non-neighbor "
                             f"ranks {sorted(extra)}")
        return row
    every = set().union(*neighbors.values()) if neighbors else set()
    extra = set(weights) - every
    if extra:
        raise ValueError(
            f"{what} references ranks {sorted(extra)} that are not "
            "neighbors of any rank under the current topology")
    return {p: w for p, w in weights.items() if p in mine}


def _self_weight(value, me: int, size: int) -> float:
    """A scalar, or a per-rank ``{rank: w}`` read at this rank."""
    if isinstance(value, dict):
        missing = set(range(size)) - set(value)
        if missing:
            raise ValueError(
                f"self_weight missing entries for ranks {sorted(missing)}")
        return float(value[me])
    return float(value)


def _acquire_all(win: Window, ranks) -> None:
    """Acquire in order, releasing everything on a mid-sequence failure."""
    acquired = []
    try:
        for r in ranks:
            win.host.mutex_acquire(r)
            acquired.append(r)
    except BaseException:
        for r in reversed(acquired):
            try:
                win.host.mutex_release(r)
            except Exception:  # noqa: BLE001 — unwind must not mask
                pass
        raise


def _release_all(win: Window, ranks) -> None:
    for r in reversed(list(ranks)):
        win.host.mutex_release(r)


def _check_mutex_world(win: Window, what: str) -> None:
    """A mutex across processes lives on the control plane: without one at
    a world of more than one there is none to take."""
    if isinstance(win.host, _LocalWinHost) and win.size > 1:
        raise RuntimeError(
            f"{what}: window mutexes across processes live on the control "
            "plane, and none is attached; attach one (a torchrun world, or "
            "BFT_CP_HOST/BFT_CP_PORT) or call without require_mutex")


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def win_create(tensor: torch.Tensor, name: str,
               zero_init: bool = False) -> bool:
    """Create a named window from this rank's tensor (collective: every
    rank creates it). Neighbour buffers start as a copy of the tensor
    unless ``zero_init``. Returns False if the name exists."""
    st = _global_state()
    st.check_initialized()
    if not isinstance(tensor, torch.Tensor):
        raise TypeError("win_create takes this rank's torch.Tensor")
    if name in st.windows:
        return False
    with timeline_context(name, "WIN_CREATE"):
        st.windows[name] = Window(name, tensor, zero_init)
    return True


def win_free(name: Optional[str] = None) -> bool:
    """Free one window, or all of them when ``name`` is None."""
    st = _global_state()
    st.check_initialized()
    if name is None:
        for win in st.windows.values():
            win.close()
        st.windows.clear()
        return True
    if name not in st.windows:
        return False
    st.windows[name].close()
    del st.windows[name]
    return True


# ---------------------------------------------------------------------------
# put / accumulate / get
# ---------------------------------------------------------------------------

def _send_deposits_delayed(names, blobs, tags, edge_of, delays):
    """Fault-injection deposit send (``BFT_CP_FAULT`` ``delay_edges``):
    ship the records grouped by their edge's injected delay, ascending."""
    groups: Dict[int, List[int]] = {}
    for i, e in enumerate(edge_of):
        groups.setdefault(int(delays.get((e[0], e[1]), 0)), []).append(i)
    replies = [0] * len(names)
    waited = 0
    for dly in sorted(groups):
        if dly > waited:
            time.sleep((dly - waited) / 1e3)
            waited = dly
        idx = groups[dly]
        sub = _cp.client().append_bytes_tagged_many(
            [names[i] for i in idx], [blobs[i] for i in idx],
            [tags[i] for i in idx])
        for i, r in zip(idx, sub):
            replies[i] = r
    return replies


def _hosted_exchange(win: Window, tensor, row: Dict[int, float], sw: float,
                     accumulate: bool, require_mutex: bool, activity: str,
                     from_get: bool):
    """One-sided put/accumulate/get over the host transport.

    A put/accumulate folds a local destination's share in place and
    deposits the rest on the server (bump-before-deposit, one pipelined
    batch, the mailbox cap checked per deposit first), then publishes the
    scaled row. A get pulls each in-neighbour's published row into this
    rank's mailbox. Nothing waits on another controller."""
    st = _global_state()
    acc_t = win._acc_np()
    me = win.owned[0]
    owned = set(win.owned)
    table = {me: row} if not from_get else {src: {me: w}
                                            for src, w in row.items()}
    # server locks of the touched ranks (a put's destinations, a get's
    # sources), in sorted order: concurrent origins cannot deadlock
    touched = sorted(table[me]) if not from_get else sorted(table)
    if require_mutex:
        _acquire_all(win, touched)
    try:
        with timeline_context(win.name, activity), _op_timer(activity), \
                win.state_mu:
            use_p = st.win_ops_with_associated_p
            if not from_get:
                p_own = win.host.read_p_owned() if use_p else None
                rows = {me: to_host(tensor)}
                edges = [(me, dst, win.layout.slot_of[dst][me])
                         for dst in sorted(table[me])]
                # version bumps first (one round-trip): a drain that finds
                # a deposit never sees its version still at 0
                win.host.bump_versions([(d, k) for _, d, k in edges],
                                       force=True)
                mode = _DEP_ACC if accumulate else _DEP_PUT
                wire_t = _win_wire_dtype(win.mail_dtype)
                dep_names: List[str] = []
                dep_blobs: List = []
                dep_tags: List[int] = []
                dep_edge_of: List[Tuple[int, int, int]] = []
                dep_flows: List = []
                deposited = set()
                dep_shard = win.active_shard if win.shard_factor > 1 else -1
                fl = _flight.recorder()
                try:
                    for src in win.owned:
                        x = cast(rows[src], acc_t)
                        dsts = sorted(table.get(src, {}))
                        # one encode per source row feeds every out-edge on
                        # the window codec; overridden edges encode apart
                        enc = est = None
                        fold_mode = mode
                        if win.codec is not None and dsts and (
                                not win._edge_codec
                                or any((src, d) not in win._edge_codec
                                       for d in dsts)):
                            enc, est, fold_mode = win._encode_row(
                                src, x, wire_t, mode)
                        for dst in dsts:
                            wt = float(table[src][dst])
                            k = win.layout.slot_of[dst][src]
                            pc = float(p_own[src] * wt) if use_p else 0.0
                            d_enc, d_est, d_fold = enc, est, fold_mode
                            d_cid = win.codec.cid if enc is not None else 0
                            x_dst = x
                            if win._edge_codec and \
                                    (src, dst) in win._edge_codec:
                                if win._edge_codec[(src, dst)] is None:
                                    d_enc = d_est = None
                                    d_fold = mode
                                    x_dst = win._edge_raw_base(
                                        (src, dst), x, mode)
                                else:
                                    d_enc, d_est, d_fold, d_wire = \
                                        win._encode_edge(
                                            (src, dst), x, wire_t, mode)
                                    d_cid = d_wire.cid
                            if dst in owned:
                                base_row = x_dst if d_est is None else d_est
                                contrib = base_row if wt == 1.0 else \
                                    base_row * np.asarray(wt, acc_t)
                                with fl.span("win.fold", a=contrib.nbytes):
                                    win._fold_record(dst, k, d_fold,
                                                     contrib)
                                if use_p:
                                    if accumulate:
                                        win.host.add_p_mail(dst, k, pc)
                                    else:
                                        win.host.set_p_mail(dst, k, pc)
                                deposited.add((src, dst, k))
                                continue
                            if d_enc is not None:
                                payload = d_enc
                                recs = _pack_deposit(
                                    mode, int(use_p), pc, payload,
                                    codec_id=d_cid, wt=wt, shard=dep_shard)
                            else:
                                payload = np.ascontiguousarray(cast(
                                    x_dst * np.asarray(wt, acc_t), wire_t))
                                recs = _pack_deposit(
                                    mode, int(use_p), pc, payload,
                                    shard=dep_shard)
                            win._dep_seq += 1
                            dep_names.extend([win._dep_key(dst, k)]
                                             * len(recs))
                            dep_blobs.extend(recs)
                            dep_tags.extend(_deposit_tags(
                                win._dep_seq, len(recs), origin=me))
                            dep_edge_of.extend([(src, dst, k)] * len(recs))
                            # flow id == the drain-side tag sequence
                            dep_flows.append((
                                (src, dst, k),
                                ((me & 0x7F) << 32)
                                | (win._dep_seq & 0xFFFFFFFF),
                                payload.nbytes))
                        # post-send self scaling (push-sum down-weighting)
                        win._rows[src] = cast(
                            x * np.asarray(sw, acc_t),
                            host_dtype(win.dtype))
                    full: set = set()
                    if dep_names:
                        full = _precheck_mailbox_cap(
                            win, dep_names, dep_blobs, dep_edge_of)
                        if full:
                            keep = [i for i, e in enumerate(dep_edge_of)
                                    if e not in full]
                            dep_names = [dep_names[i] for i in keep]
                            dep_blobs = [dep_blobs[i] for i in keep]
                            dep_tags = [dep_tags[i] for i in keep]
                            dep_edge_of = [dep_edge_of[i] for i in keep]
                    if dep_names:
                        wire_out = sum(_blen(b) for b in dep_blobs)
                        _metrics.counter("win.deposit_bytes").inc(wire_out)
                        _dl = _native.edge_delays()
                        with fl.span("win.wire", a=wire_out):
                            if _dl:
                                replies = _send_deposits_delayed(
                                    dep_names, dep_blobs, dep_tags,
                                    dep_edge_of, _dl)
                            else:
                                replies = \
                                    _cp.client().append_bytes_tagged_many(
                                        dep_names, dep_blobs, dep_tags)
                        # backstop: a -2 means this process's cap knob
                        # disagrees with the server's
                        full.update(dep_edge_of[i]
                                    for i, r in enumerate(replies)
                                    if r == -2)
                        deposited.update(
                            e for i, e in enumerate(dep_edge_of)
                            if replies[i] >= 0 and e not in full)
                    if full:
                        _metrics.counter("win.deposits_rejected").inc(
                            len(full))
                        raise RuntimeError(
                            f"window '{win.name}': deposit mailbox full "
                            f"for edges (src, dst, slot) {sorted(full)} "
                            "(server byte cap, BFT_CP_MAILBOX_MAX_MB) — "
                            "the owning controller has not drained; it "
                            "may be dead (check bf.dead_controllers())")
                    # one flow arrow per landed remote deposit; the flight
                    # ring gets the same pairing and per-edge bytes
                    sent = 0
                    for edge, fid, nbytes in dep_flows:
                        if edge in deposited:
                            timeline_flow_start(_FLOW_DEPOSIT, fid)
                            fl.rec(_flight.FLOW_S,
                                   fl.intern(f"edge.{edge[0]}.{edge[1]}"),
                                   nbytes, fid)
                            sent += 1
                    if sent:
                        _metrics.counter("win.deposits_sent").inc(sent)
                    with fl.span("win.publish"):
                        win._publish_selves(win.owned)
                except Exception:
                    # un-bump the edges whose deposits never landed
                    try:
                        missing = [(d, k) for s, d, k in edges
                                   if (s, d, k) not in deposited]
                        if missing:
                            win.host.bump_versions(missing, force=True,
                                                   delta=-1)
                    except Exception:  # noqa: BLE001
                        pass
                    raise
                if use_p:
                    win.host.write_p_entries({
                        src: p_own[src] * float(sw) for src in win.owned})
            else:
                # pull each in-edge source's published row into MY mailbox
                p_all = win.host.read_p() if use_p else None
                remote_srcs = sorted(src for src in table if src not in owned)
                pulled = []
                fl = _flight.recorder()

                def fold_src(src, val):
                    contrib_base = cast(val, acc_t)
                    for dst in win.owned:
                        wt = table[src].get(dst)
                        if wt is None:
                            continue
                        k = win.layout.slot_of[dst][src]
                        with fl.span("win.fold", a=contrib_base.nbytes):
                            win._fold_record(
                                dst, k, _DEP_PUT,
                                contrib_base * np.asarray(wt, acc_t))
                        if use_p:
                            win.host.set_p_mail(dst, k,
                                                float(p_all[src] * wt))
                        pulled.append((dst, k))

                for src in sorted(owned & set(table)):
                    fold_src(src, win._rows[src])
                # every remote source in flight at once (pool-bounded),
                # folding in source order as they land
                depth = max(2, getattr(_cp.client(), "streams", 1))
                fetches: Dict[int, _Prefetch] = {}

                def launch(j):
                    fetches[j] = _Prefetch(
                        lambda s=remote_srcs[j]:
                        win._read_remote_self_view(s))

                fl.begin("win.wire")
                try:
                    for j in range(min(depth, len(remote_srcs))):
                        launch(j)
                    for j, src in enumerate(remote_srcs):
                        row_v, owner = fetches.pop(j).result()
                        if j + depth < len(remote_srcs):
                            launch(j + depth)
                        try:
                            fold_src(src, row_v)
                        finally:
                            owner.close()
                finally:
                    fl.end("win.wire")
                win.host.bump_versions(pulled)
    finally:
        if require_mutex:
            _release_all(win, touched)
    return _handles.allocate(f"{activity.lower()}.{win.name}", [],
                             lambda: True)


def _collective_start(win: Window, x: torch.Tensor,
                      sends: Dict[int, tuple]):
    """Issue one exchange round: every shift's static edge carries its
    payload and an f64 meta ``(active, weight, p)`` both ways, all in one
    ``batch_isend_irecv``. ``sends[dst]`` is this rank's meta for its
    out-edge to ``dst``. Returns ``(work, arrivals)``, arrivals being
    ``(src, slot, payload, meta)`` per in-edge."""
    lay = win.layout
    n, me = lay.n, win.rank
    x = x.contiguous()
    ops, arrivals = [], []
    for si, s in enumerate(lay.shifts):
        dst, src = (me + s) % n, (me - s) % n
        if lay.has_edge[si, dst]:
            meta = torch.tensor(sends.get(dst, (0.0, 0.0, 0.0)),
                                dtype=torch.float64, device=x.device)
            ops.append(dist.P2POp(dist.isend, x, dst))
            ops.append(dist.P2POp(dist.isend, meta, dst))
        if lay.has_edge[si, me]:
            buf = torch.empty_like(x)
            meta_in = torch.empty(3, dtype=torch.float64, device=x.device)
            ops.append(dist.P2POp(dist.irecv, buf, src))
            ops.append(dist.P2POp(dist.irecv, meta_in, src))
            arrivals.append((src, int(lay.slot[si, me]), buf, meta_in))
    work = [_OnceWork(w) for w in dist.batch_isend_irecv(ops)] if ops \
        else []
    return work, arrivals


def _collective_exchange(win: Window, tensor, row: Dict[int, float],
                         sw: float, accumulate: bool, require_mutex: bool,
                         activity: str, from_get: bool):
    """The collective plane's put/accumulate/get: one lockstep exchange
    over the process group, then the receiver-side blend (in issue order,
    at ``win_wait`` or before the window's next op). Versions and p mail
    of the received slots are the receiver's; p rescales by the sender."""
    st = _global_state()
    me = win.rank
    use_p = st.win_ops_with_associated_p
    with win.state_mu:
        win._settle()
        # the touched rank is this one when someone may write to it (put)
        # or read it (get); the control plane locks owned ranks only
        busy = win.out_neighbors[me] if from_get else win.in_neighbors[me]
        touched = [me] if busy else []
        if require_mutex:
            _check_mutex_world(win, activity.lower())
            _acquire_all(win, win.host.op_mutex_ranks(touched))
        try:
            p_me = win.host.read_p_owned()[me] if use_p else 0.0
            if from_get:
                x = win.self_value
                sends = {dst: (1.0, 1.0, p_me) for dst in win.out_neighbors[me]}
            else:
                x = tensor.detach()
                sends = {dst: (1.0, float(w), p_me) for dst, w in row.items()}
            with timeline_context(win.name, activity), _op_timer(activity):
                work, arrivals = _collective_start(win, x, sends)
            blend = win._blend_code()

            def finish() -> None:
                for w in work:
                    w.wait()
                bumped = []
                for src, slot, buf, meta in arrivals:
                    m = meta.tolist()
                    if from_get:
                        active = src in row
                        weight = float(row.get(src, 0.0))
                    else:
                        active, weight = bool(m[0]), m[1]
                    if fold_arrival(win.mail, win.host, me, slot, buf,
                                    active, weight, m[2],
                                    accumulate and not from_get, use_p,
                                    blend):
                        bumped.append((me, slot))
                win.host.bump_versions(bumped)
                if not from_get:
                    acc_t = _win_acc_dtype(x.dtype)
                    if sw == 1.0:
                        win._self_value = x.clone()
                    else:
                        win._self_value = (x.to(acc_t) * float(
                            np.float32(sw))).to(x.dtype)
                    if use_p:
                        win.host.write_p_entries({me: p_me * float(sw)})
                win.host.flush()

            win._pending.append(finish)
            if require_mutex:
                win._settle()
        finally:
            if require_mutex:
                _release_all(win, win.host.op_mutex_ranks(touched))
    return _handles.allocate(f"{activity.lower()}.{win.name}", work,
                             lambda: (win._settle(), True)[1])


def _do_exchange(win: Window, tensor, row: Dict[int, float], sw: float,
                 accumulate: bool, require_mutex: bool, activity: str,
                 from_get: bool = False):
    if win.hosted:
        return _hosted_exchange(win, tensor, row, sw, accumulate,
                                require_mutex, activity, from_get)
    return _collective_exchange(win, tensor, row, sw, accumulate,
                                require_mutex, activity, from_get)


def _check_tensor(win: Window, tensor, what: str) -> None:
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"{what} takes this rank's torch.Tensor")
    if tuple(tensor.shape) != win.row_shape:
        raise ValueError(f"{what}: tensor of shape {tuple(tensor.shape)} "
                         f"for window '{win.name}' of shape {win.row_shape}")


def win_put_nonblocking(tensor: torch.Tensor, name: str,
                        self_weight: Optional[Weights] = None,
                        dst_weights: Optional[Weights] = None,
                        require_mutex: bool = False) -> int:
    """Write ``tensor * w`` into each destination's mailbox slot for this
    rank; the stored window tensor then becomes ``tensor * self_weight``
    (the reference's post-send scaling, mpi_ops.py:1036-1073)."""
    win = _get_window(name)
    st = _global_state()
    _check_tensor(win, tensor, "win_put")
    row = _row_weights(dst_weights, win.rank, win.out_neighbors, 1.0,
                       "dst_weights")
    sw = _self_weight(1.0 if self_weight is None else self_weight,
                      win.rank, st.size)
    return _do_exchange(win, tensor, row, sw, accumulate=False,
                        require_mutex=require_mutex, activity="WIN_PUT")


def win_put(tensor: torch.Tensor, name: str, self_weight=None,
            dst_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_put_nonblocking(tensor, name, self_weight,
                                        dst_weights, require_mutex))


def win_accumulate_nonblocking(tensor: torch.Tensor, name: str,
                               self_weight: Optional[Weights] = None,
                               dst_weights: Optional[Weights] = None,
                               require_mutex: bool = False) -> int:
    """Add ``tensor * w`` into each destination's mailbox slot for this
    rank (SUM only, as the reference, mpi_ops.py:1168-1213)."""
    win = _get_window(name)
    st = _global_state()
    _check_tensor(win, tensor, "win_accumulate")
    row = _row_weights(dst_weights, win.rank, win.out_neighbors, 1.0,
                       "dst_weights")
    sw = _self_weight(1.0 if self_weight is None else self_weight,
                      win.rank, st.size)
    return _do_exchange(win, tensor, row, sw, accumulate=True,
                        require_mutex=require_mutex,
                        activity="WIN_ACCUMULATE")


def win_accumulate(tensor: torch.Tensor, name: str, self_weight=None,
                   dst_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_accumulate_nonblocking(
        tensor, name, self_weight, dst_weights, require_mutex))


def win_get_nonblocking(name: str, src_weights: Optional[Weights] = None,
                        require_mutex: bool = False) -> int:
    """Pull each in-neighbour's current window tensor, times its weight,
    into this rank's mailbox (mpi_ops.py:1105-1136); ``win_update`` then
    surfaces it."""
    win = _get_window(name)
    row = _row_weights(src_weights, win.rank, win.in_neighbors, 1.0,
                       "src_weights")
    return _do_exchange(win, None, row, 1.0, accumulate=False,
                        require_mutex=require_mutex, activity="WIN_GET",
                        from_get=True)


def win_get(name: str, src_weights=None, require_mutex: bool = False) -> bool:
    return win_wait(win_get_nonblocking(name, src_weights, require_mutex))


# ---------------------------------------------------------------------------
# update (the local combine; reference "win_sync")
# ---------------------------------------------------------------------------

def _update_weights(win: Window, self_weight, neighbor_weights):
    """This rank's (self weight, {src: w}): the topology's receive weights
    when weighted, else the uniform 1/(indegree+1), unless given."""
    st = _global_state()
    me = win.rank
    if (self_weight is None) != (neighbor_weights is None):
        raise ValueError(
            "self_weight and neighbor_weights must be presented together")
    if self_weight is None:
        if st.is_topo_weighted:
            s, w = topology_util.GetRecvWeights(st.topology, me)
            return float(s), dict(w)
        u = 1.0 / (len(win.in_neighbors[me]) + 1)
        return u, {src: u for src in win.in_neighbors[me]}
    return (_self_weight(self_weight, me, st.size),
            _row_weights(neighbor_weights, me, win.in_neighbors, 1.0,
                         "neighbor_weights"))


def win_update(name: str, self_weight: Optional[Weights] = None,
               neighbor_weights: Optional[Weights] = None,
               reset: bool = False, clone: bool = False,
               require_mutex: bool = False) -> torch.Tensor:
    """Combine this rank's window tensor with its mailbox slots:
    ``sw * self + sum_src w[src] * mail[src]`` (DoWinSync,
    mpi_win_ops.cc:185-238). ``reset`` zeroes the slots read; ``clone``
    leaves the stored tensor unchanged; the versions of the slots read go
    to 0. Returns this rank's combined tensor; on the collective plane
    without ``clone`` it IS the window's stored tensor, as BlueFog's
    win_update writes the registered tensor in place."""
    win = _get_window(name)
    st = _global_state()
    me = win.rank
    sw, nw_row = _update_weights(win, self_weight, neighbor_weights)
    lay = win.layout
    nw = np.zeros(lay.d_max, np.float32)
    read_mask = np.zeros(lay.d_max, np.float32)
    for src, wt in nw_row.items():
        k = lay.slot_of[me][src]
        nw[k] = wt
        read_mask[k] = 1.0
    if win.hosted:
        return _hosted_update(win, sw, nw_row, nw, read_mask, reset, clone,
                              require_mutex)
    use_p = st.win_ops_with_associated_p
    with timeline_context(name, "WIN_UPDATE"), _op_timer("WIN_UPDATE"):
        if require_mutex:
            _check_mutex_world(win, "win_update")
            _acquire_all(win, win.host.op_mutex_ranks([me]))
        win.state_mu.acquire()
        try:
            win._settle()
            resets = [k for k in range(lay.d_max) if reset and read_mask[k]]
            result = combine(win.self_value, win.mail, sw, nw.tolist(),
                             resets)
            if use_p:
                p_own = win.host.read_p_owned()[me]
                p_mail = win.host.read_p_mail_owned()[me]
                new_p = p_combine(sw, p_own, nw, p_mail)
            win.host.reset_versions((me, lay.slot_of[me][src])
                                    for src in nw_row)
            if reset and use_p:
                win.host.write_p_mail_rows(
                    {me: p_mail * (1.0 - read_mask.astype(np.float64))})
            if not clone:
                win.self_value = result
                if use_p:
                    win.host.write_p_entries({me: new_p})
            win.host.flush()
        finally:
            win.state_mu.release()
            if require_mutex:
                _release_all(win, win.host.op_mutex_ranks([me]))
    return result


def _hosted_update(win: Window, sw: float, nw_row: Dict[int, float], nw,
                   read_mask, reset: bool, clone: bool,
                   require_mutex: bool) -> torch.Tensor:
    """The hosted plane's owner-local combine: drain and fold this rank's
    pending deposits, then combine. Other ranks are their owners'
    business, which is what makes a sleeping peer harmless."""
    st = _global_state()
    acc_t = win._acc_np()
    lay = win.layout
    with timeline_context(win.name, "WIN_UPDATE"), _op_timer("WIN_UPDATE"):
        if require_mutex:
            _acquire_all(win, win.owned)
        win.state_mu.acquire()
        try:
            win._drain_deposits(strict=require_mutex)
            use_p = st.win_ops_with_associated_p
            if use_p:
                p_own = win.host.read_p_owned()
                p_mail = win.host.read_p_mail_owned()
            results: Dict[int, np.ndarray] = {}
            for r in win.owned:
                combined = np.multiply(cast(win._rows[r], acc_t),
                                       np.asarray(sw, acc_t), dtype=acc_t)
                for src, wt in nw_row.items():
                    k = lay.slot_of[r][src]
                    np.add(combined,
                           np.multiply(cast(win._mail_rows[r][k], acc_t),
                                       np.asarray(wt, acc_t), dtype=acc_t),
                           out=combined)
                results[r] = cast(combined, host_dtype(win.dtype))
                if reset:
                    keep = (1.0 - read_mask).reshape(
                        (lay.d_max,) + (1,) * len(win.row_shape))
                    win._mail_rows[r] = cast(
                        cast(win._mail_rows[r], acc_t) * keep.astype(acc_t),
                        host_dtype(win.mail_dtype))
            win.host.reset_versions(
                (r, lay.slot_of[r][src]) for r in win.owned for src in nw_row)
            if reset and use_p:
                win.host.write_p_mail_rows({
                    r: p_mail[r] * (1.0 - read_mask.astype(np.float64))
                    for r in win.owned})
            pub = None
            if not clone:
                for r in win.owned:
                    win._rows[r] = results[r]
                if use_p:
                    win.host.write_p_entries({
                        r: p_combine(sw, p_own[r], nw, p_mail[r])
                        for r in win.owned})
                # stream the publish while the result moves to the device;
                # joined before the locks release
                pub = _Prefetch(lambda: win._publish_selves(win.owned))
            out = from_host(results[win.owned[0]], win.dtype, win.device)
            if pub is not None:
                pub.result()
        finally:
            win.state_mu.release()
            if require_mutex:
                _release_all(win, win.owned)
    return out


def win_update_then_collect(name: str,
                            require_mutex: bool = True) -> torch.Tensor:
    """Sum self and every neighbour buffer, then clear them
    (mpi_ops.py:940-956)."""
    win = _get_window(name)
    return win_update(
        name, self_weight=1.0,
        neighbor_weights={src: 1.0 for src in win.in_neighbors[win.rank]},
        reset=True, require_mutex=require_mutex)


def win_fence(name: str) -> bool:
    """Close the window's RMA epoch: collective over every controller. On
    return every put/accumulate/get issued before the fence is folded at
    its target. Collective plane: settle and barrier. Hosted plane:
    barrier, each owner drains, barrier."""
    win = _get_window(name)
    with timeline_context(name, "WIN_FENCE"), _op_timer("WIN_FENCE"):
        if not win.hosted:
            win._settle()
        win.host.flush()
        if win.hosted:
            with win.state_mu:
                win._drain_deposits()
            win.host.flush()
    return True


# ---------------------------------------------------------------------------
# poll / wait / versions / mutex / associated-p
# ---------------------------------------------------------------------------

def win_poll(handle: int) -> bool:
    return _handles.poll(handle)


def win_wait(handle: int) -> bool:
    """Wait for a window op's handle (``BFT_SYNC_TIMEOUT`` and
    ``PeerLostError`` as for ``synchronize``)."""
    _handles.synchronize(handle)
    return True


def get_win_version(name: str, rank: Optional[int] = None) -> Dict[int, int]:
    """Versions of ``rank``'s neighbour buffers (default: this rank's):
    the number of writes since the last ``win_update`` read each
    (mpi_ops.py:1257-1272). Without a control plane a process reads only
    its own rank's."""
    win = _get_window(name)
    win._settle()
    r = win.rank if rank is None else rank
    return {
        src: win.host.get_version(r, win.layout.slot_of[r][src])
        for src in win.in_neighbors[r]
    }


class win_mutex:
    """Hold the window mutexes of the given ranks (default: this rank's
    out-neighbours; ``for_self``: this rank), as bf.win_mutex
    (mpi_ops.py:1304-1336). Needs a control plane at a world of more than
    one."""

    def __init__(self, name: str, for_self: bool = False,
                 ranks: Optional[Sequence[int]] = None,
                 rank: Optional[int] = None) -> None:
        self._win = _get_window(name)
        _check_mutex_world(self._win, "win_mutex")
        me = self._win.rank if rank is None else rank
        if ranks is None:
            ranks = [me] if for_self else self._win.out_neighbors[me]
        self._ranks = sorted(set(ranks))

    def __enter__(self):
        _acquire_all(self._win, self._ranks)
        return self

    def __exit__(self, *exc):
        _release_all(self._win, self._ranks)
        return False


class win_lock:
    """RMA access-epoch context manager: validation only (mailbox writes
    are ordered by construction)."""

    def __init__(self, name: str) -> None:
        _get_window(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def win_associated_p(name: str, rank: Optional[int] = None) -> float:
    """The push-sum scalar p of ``rank`` (default: this rank; init 1.0)."""
    win = _get_window(name)
    win._settle()
    if rank is None or rank in win.owned:
        return float(win.host.read_p_owned()[
            win.rank if rank is None else rank])
    return float(win.host.read_p()[rank])


def win_associated_p_all(name: str) -> np.ndarray:
    """Every rank's p (an all-gather every rank calls, without a control
    plane at a world of more than one)."""
    win = _get_window(name)
    win._settle()
    return win.host.read_p()


def turn_on_win_ops_with_associated_p() -> None:
    _global_state().win_ops_with_associated_p = True


def turn_off_win_ops_with_associated_p() -> None:
    _global_state().win_ops_with_associated_p = False


__all__ = [
    "win_create", "win_free", "win_put", "win_put_nonblocking",
    "win_accumulate", "win_accumulate_nonblocking", "win_get",
    "win_get_nonblocking", "win_update", "win_update_then_collect",
    "win_fence", "win_poll", "win_wait", "get_win_version", "win_mutex",
    "win_lock", "win_associated_p", "win_associated_p_all",
    "turn_on_win_ops_with_associated_p",
    "turn_off_win_ops_with_associated_p",
]
