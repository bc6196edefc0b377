"""Read-only inference client over the snapshot plane.

Counterpart of ``bluefog_tpu/serving/client.py``. A :class:`ServeClient`
attaches to the control plane the way ``--status`` does (a raw client, no
process group) and runs three concerns on top of it:

* **Puller.** The ``bf-serve-poll`` thread watches the ``bf.serve.ver``
  fence and, on a bump, pulls the new snapshot's shards in parallel: keys
  are grouped by the router's FNV placement and each group is fetched on a
  dedicated per-endpoint client, so pull bandwidth scales with the
  control-plane shard count. The fetched leaves are copied into FRESH
  tensors on the client's device on a stream of their own; the copy is
  waited for before the new list is published under the swap lock, so a
  request is always served by exactly one complete version and no batch
  ever reads a half-copied leaf. During a swap two versions live on the
  device.

* **Batcher.** ``submit()`` enqueues one example and returns a future; the
  ``bf-serve-batch`` thread drains the queue into stacked batches (at most
  ``BFT_SERVE_BATCH``, lingering ``BFT_SERVE_BATCH_WAIT_MS``), copies each
  batch to the device, runs ``model_fn(params, batch)`` under
  ``torch.inference_mode`` on a stream of its own, and brings the outputs
  back to the host in one copy before the batch's decode spans end.
  Futures resolve to numpy rows, as the JAX package's do.

* **Admission gate.** Before enqueueing, ``submit()`` reads the telemetry
  the trainer publishes (queue depth, control-plane mailbox pressure,
  publish lag, live alert blobs) and resolves to ``accept``, ``queue``
  (admitted, counted as degraded) or ``shed`` (:class:`RequestShed`).

Streams: the trainer (if any) issues on the device's default stream, the
batcher on its own stream and the puller's copies on another, so serving
never waits for a queued training step. Each thread selects the client's
device itself.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import queue as _queue
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import flight as _flight
from ..runtime import metrics as _metrics
from ..runtime.config import knob_env
from ..runtime.logging import logger
from ..runtime.router import _fnv64
from . import snapshot as _snap

# Sliding window for the tick-time latency/staleness percentile gauges
# (a slotted numpy ring: the per-request store is two array writes).
_PCT_RING = 512

# admission verdict codes carried in the serve.admit span-end `a` column
_ADMIT_CODE = {"accept": 0.0, "queue": 1.0, "shed": 2.0}

# names the tracer interns at attach, so the per-request path is rec()
# calls only
_TRACE_NAMES = ("serve.req", "serve.admit", "serve.queue", "serve.linger",
                "serve.decode", "serve.pull", "serve.pull.ep",
                "serve.failover", "serve.snap")


class RequestShed(RuntimeError):
    """The admission gate refused this request (overload protection).

    Callers should back off and retry later; ``gate`` names the input that
    tripped (``queue_full`` / ``mailbox`` / ``closed``)."""

    def __init__(self, message: str, gate: str = "") -> None:
        self.gate = gate
        super().__init__(message)


def _endpoint_for(key: str, n: int) -> int:
    return _fnv64(key) % n


def _client_device(device) -> torch.device:
    """The device a client serves on: the current CUDA device unless the
    caller asks for another (``"cpu"`` included); raises without a GPU."""
    from ..runtime.state import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_host(ys) -> np.ndarray:
    """A batch's outputs on the host (one copy for a device tensor)."""
    if isinstance(ys, torch.Tensor):
        ys = ys.detach()
        if ys.dtype in (torch.bfloat16, torch.float16):
            ys = ys.float()
        return ys.cpu().numpy()
    return np.asarray(ys)


class ServeClient:
    """Versioned-snapshot puller and batched read-only inference server.

    ``model_fn(params, batch) -> outputs`` receives the snapshot's leaves
    as tensors on ``device`` (in the publisher's leaf order) and the batch
    stacked as one tensor on ``device``. Without a ``model_fn`` the client
    still pulls and hot-swaps: ``params()``/``version()`` expose the
    freshest complete snapshot. ``device=None`` is the current CUDA device
    (raising when there is none); pass ``device="cpu"`` to serve on the
    CPU.
    """

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 model_fn: Optional[Callable] = None, *,
                 secret: str = "", streams: Optional[int] = None,
                 poll_s: Optional[float] = None,
                 register: bool = True, start: bool = True,
                 device=None) -> None:
        from ..runtime.native import ControlPlaneClient
        from ..runtime.router import ShardRouter

        if not endpoints:
            raise ValueError("ServeClient needs at least one control-plane "
                             "endpoint")
        self._device = _client_device(device)
        self._endpoints = [(str(h), int(p)) for h, p in endpoints]
        self._secret = secret
        self._streams = streams
        self._model_fn = model_fn
        self._poll_s = float(knob_env("BFT_SERVE_POLL_S")) \
            if poll_s is None else float(poll_s)
        # scalar/meta/telemetry path: the same lenient attach --status uses
        if len(self._endpoints) == 1:
            host, port = self._endpoints[0]
            self._cl = ControlPlaneClient(host, port, 0, secret=secret,
                                          streams=1)
        else:
            self._cl = ShardRouter(self._endpoints, 0, secret=secret,
                                   streams=1, lenient=True)
        # bulk path: dedicated per-endpoint clients, dialed lazily so a
        # shard that is down between publishes never blocks attach
        self._bulk: Dict[int, ControlPlaneClient] = {}
        self._bulk_mu = threading.Lock()
        self._pace_mbps = 0.0  # bench/test hook, see pull_blobs()
        if self._device.type == "cuda":
            self._h2d_stream = torch.cuda.Stream(self._device)
            self._run_stream = torch.cuda.Stream(self._device)

        self._mu = threading.Lock()          # guards the swap state below
        self._pull_mu = threading.Lock()     # one pull at a time
        self._params: Optional[List[torch.Tensor]] = None
        self._version = 0
        self._meta: Optional[_snap.SnapshotMeta] = None
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._health: dict = {}
        self._stats = {"swaps": 0, "pulls": 0, "pull_failures": 0,
                       "wire_bytes": 0, "pull_mbps": 0.0,
                       "accepted": 0, "queued": 0, "shed": 0,
                       "requests": 0, "batches": 0}
        # submitters, the batcher and the poller all count: each
        # read-modify-write of a counter takes this lock
        self._stats_mu = threading.Lock()

        # -- request-path tracing and SLO recording --------------------------
        # Both are opt-in; with the knobs unset nothing below records,
        # publishes, or changes the wire.
        from ..runtime.timeseries import parse_slos

        self._trace = bool(knob_env("BFT_TRACE_SERVE"))
        self._slos = parse_slos(knob_env("BFT_SLO"))
        self._fence_ver = 0      # latest fence the poller saw (staleness)
        self._failover_open = False
        self._rec = None
        self._nid: Dict[str, int] = {}
        if self._trace:
            r = _flight.recorder()
            self._rec = r
            self._nid = {n: r.intern(n) for n in _TRACE_NAMES}
            # 63-bit trace ids: random high bits per client, low bits a
            # GIL-atomic counter
            self._tid_base = (int.from_bytes(os.urandom(6), "little")
                              << 16) & 0x7FFFFFFFFFFFFFFF
            self._tid_iter = itertools.count(1)
            self._m_traced = _metrics.counter("trace.requests")
        self._ts = None
        if self._slos:
            from ..runtime.timeseries import TimeSeriesStore

            self._ts = TimeSeriesStore()
            self._m_req = _metrics.counter("slo.requests")
            self._m_shed = _metrics.counter("slo.shed")
            self._m_lat_h = _metrics.histogram(
                "slo.request_us",
                bounds=(100, 250, 500, 1000, 2500, 5000, 10000, 25000,
                        50000, 100000, 250000, 1000000))
            self._m_stal_h = _metrics.histogram(
                "slo.staleness_ver", bounds=(0, 1, 2, 3, 5, 8, 13, 21, 34))
            self._m_breach = {o.name: _metrics.counter("slo.breach."
                                                       + o.name)
                              for o in self._slos}
            self._lat_ring = np.zeros(_PCT_RING, np.float64)
            self._lat_n = 0
            self._stal_ring = np.zeros(_PCT_RING, np.float64)
            self._stal_n = 0

        qmax = int(knob_env("BFT_SERVE_QUEUE_MAX"))
        soft = int(knob_env("BFT_SERVE_QUEUE_SOFT")) or max(1, qmax // 2)
        self._qmax, self._qsoft = qmax, min(soft, qmax)
        self._stale_s = float(knob_env("BFT_SERVE_STALE_S"))
        self._mailbox_cap: Optional[int] = None
        self._batch_max = max(1, int(knob_env("BFT_SERVE_BATCH")))
        self._linger_s = max(
            0.0, float(knob_env("BFT_SERVE_BATCH_WAIT_MS")) / 1e3)
        self._q: "_queue.Queue" = _queue.Queue(maxsize=qmax)

        self._cid = -1
        if register:
            # reuses expired heartbeat slots so bf.serve.client.<cid>
            # keys stay bounded by the peak concurrent client count
            self._cid = _snap.claim_client_slot(self._cl)

        self._threads: List[threading.Thread] = []
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._threads:
            return
        t = threading.Thread(target=self._poll_loop,
                             name="bf-serve-poll", daemon=True)
        t.start()
        self._threads.append(t)
        if self._model_fn is not None:
            t = threading.Thread(target=self._batch_loop,
                                 name="bf-serve-batch", daemon=True)
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
        while True:  # fail anything still parked in the queue
            try:
                item = self._q.get_nowait()
            except _queue.Empty:
                break
            fut = item[1]
            if not fut.done():
                fut.set_exception(RequestShed("serve client closed",
                                              gate="closed"))
        _snap.release_client_slot(self._cl, self._cid)
        with self._bulk_mu:
            for cl in self._bulk.values():
                try:
                    cl.close()
                except (OSError, RuntimeError):
                    pass
            self._bulk.clear()
        try:
            self._cl.close()
        except (OSError, RuntimeError):
            pass
        with self._mu:
            self._params = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- snapshot access ---------------------------------------------------

    def params(self) -> Optional[List[torch.Tensor]]:
        """The serving version's leaves: tensors on the client's device,
        in the publisher's leaf order (a bf16 leaf arrives as f32)."""
        with self._mu:
            return self._params

    def version(self) -> int:
        with self._mu:
            return self._version

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the first complete snapshot is swapped in."""
        return self._ready.wait(timeout)

    def refresh(self) -> int:
        """Synchronous poll: pull and swap if the fence moved. Returns the
        serving version after the check."""
        self._maybe_pull()
        return self.version()

    # -- parallel bulk puller ---------------------------------------------

    def _bulk_client(self, idx: int):
        from ..runtime.native import ControlPlaneClient

        with self._bulk_mu:
            cl = self._bulk.get(idx)
            if cl is None:
                # a shard that died and rejoined on a new port re-points
                # the router's endpoint table; bulk re-dials follow it
                eps = self._cl.endpoints \
                    if hasattr(self._cl, "endpoints") else self._endpoints
                host, port = eps[idx]
                cl = ControlPlaneClient(host, port, 0, secret=self._secret,
                                        streams=self._streams)
                self._bulk[idx] = cl
            return cl

    def _drop_bulk_client(self, idx: int) -> None:
        with self._bulk_mu:
            cl = self._bulk.pop(idx, None)
        if cl is not None:
            try:
                cl.close()
            except (OSError, RuntimeError):
                pass

    def pull_blobs(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """Fetch ``keys`` grouped by FNV placement, one thread and one
        dedicated client per control-plane endpoint."""
        n = len(self._endpoints)
        groups: Dict[int, List[int]] = {}
        for pos, key in enumerate(keys):
            groups.setdefault(_endpoint_for(key, n), []).append(pos)
        out: List[Optional[bytes]] = [None] * len(keys)
        errs: List[str] = []

        def pull_group(idx: int, positions: List[int]) -> None:
            t0 = time.perf_counter()
            rec = self._rec
            if rec is not None:
                rec.rec(_flight.SPAN_B, self._nid["serve.pull.ep"],
                        0.0, idx)
            try:
                blobs = self._bulk_client(idx).get_bytes_many(
                    [keys[p] for p in positions])
                for p, b in zip(positions, blobs):
                    out[p] = b
                if self._pace_mbps > 0.0:
                    # bench/test hook: a per-endpoint link capacity; the
                    # groups sleep out their byte budgets concurrently
                    nbytes = sum(len(b) for b in blobs if b)
                    time.sleep(max(0.0, nbytes / (self._pace_mbps * 1e6)
                                   - (time.perf_counter() - t0)))
                if rec is not None:
                    rec.rec(_flight.SPAN_E, self._nid["serve.pull.ep"],
                            float(sum(len(b) for b in blobs if b)), idx)
                    # flow finishes pair with the publisher's starts by
                    # the key-derived id: the cross-process arrow
                    for p, b in zip(positions, blobs):
                        if b is not None and len(b):
                            rec.rec(_flight.FLOW_F,
                                    self._nid["serve.snap"], float(len(b)),
                                    _snap.trace_flow_id(keys[p]))
            except (OSError, RuntimeError) as exc:
                if rec is not None:
                    rec.rec(_flight.SPAN_E, self._nid["serve.pull.ep"],
                            -1.0, idx)
                self._drop_bulk_client(idx)
                errs.append(f"{self._endpoints[idx][0]}:"
                            f"{self._endpoints[idx][1]}: {exc}")

        if len(groups) == 1:
            idx, positions = next(iter(groups.items()))
            pull_group(idx, positions)
        else:
            workers = [threading.Thread(target=pull_group, args=(i, ps),
                                        daemon=True)
                       for i, ps in groups.items()]
            for w in workers:
                w.start()
            for w in workers:
                w.join()
        if errs:
            raise OSError("snapshot pull failed on "
                          f"{len(errs)}/{len(groups)} endpoint group(s): "
                          + "; ".join(errs))
        return out

    def _to_device(self, leaves: List[np.ndarray]) -> List[torch.Tensor]:
        """Fresh tensors on the client's device holding ``leaves``; on a
        GPU the copies run on the puller's stream and are complete when
        this returns."""
        if self._device.type == "cpu":
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in leaves]
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._h2d_stream):
            out = [torch.from_numpy(np.ascontiguousarray(a)).to(
                self._device, non_blocking=True) for a in leaves]
        self._h2d_stream.synchronize()
        return out

    def _install(self, leaves: List[np.ndarray], ver: int, wire: int,
                 dt: float) -> bool:
        """Copy a fetched version to the device and make it the serving
        one; False when a newer version is already serving."""
        if ver <= self.version():
            return False
        params = self._to_device(leaves)
        with self._mu:
            if ver <= self._version:
                return False  # raced with a concurrent swap
            self._params = params
            self._version = ver
            self._bump("swaps")
            self._bump("pulls")
            self._bump("wire_bytes", wire)
            self._stats["pull_mbps"] = wire / dt / 1e6
        return True

    def _maybe_pull(self) -> None:
        with self._pull_mu:
            self._pull_once()

    def _pull_once(self) -> None:
        ver = _snap.current_version(self._cl)
        if ver > self._fence_ver:
            self._fence_ver = ver   # staleness baseline, even when caught up
        if ver <= self._version or ver == 0:
            return
        if self._meta is None:
            self._meta = _snap.fetch_meta(self._cl)
            if self._meta is None:
                return  # fence moved but meta not visible yet; next poll
        t0 = time.perf_counter()
        rec = self._rec
        if rec is not None:
            rec.rec(_flight.SPAN_B, self._nid["serve.pull"], 0.0, ver)
        try:
            got = _snap.fetch_snapshot(self._cl, meta=self._meta,
                                       pull=self.pull_blobs)
        except (OSError, RuntimeError) as exc:
            self._bump("pull_failures")
            if rec is not None:
                rec.rec(_flight.SPAN_E, self._nid["serve.pull"], -1.0, ver)
                if not self._failover_open:
                    # opened on the first failed attempt, closed when a
                    # successor answers: the trace's failover span
                    self._failover_open = True
                    rec.rec(_flight.SPAN_B, self._nid["serve.failover"],
                            0.0, ver)
            logger.warning("serve client: snapshot pull failed (%s); "
                           "keeping version %d", exc, self._version)
            return
        if got is None:
            if rec is not None:
                rec.rec(_flight.SPAN_E, self._nid["serve.pull"], 1.0, ver)
            return
        leaves, got_ver, wire = got
        dt = max(1e-9, time.perf_counter() - t0)
        # the pull span covers the device copy: a version is pulled when
        # it can answer
        self._install(leaves, got_ver, wire, dt)
        if rec is not None:
            rec.rec(_flight.SPAN_E, self._nid["serve.pull"], 1.0, ver)
            if self._failover_open:
                self._failover_open = False
                rec.rec(_flight.SPAN_E, self._nid["serve.failover"],
                        0.0, got_ver)
        self._ready.set()

    # -- poller ------------------------------------------------------------

    def _poll_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while not self._stop.is_set():
            try:
                self._maybe_pull()
            except (OSError, RuntimeError, ValueError) as exc:
                self._bump("pull_failures")
                logger.warning("serve client: poll failed (%s)", exc)
            try:
                self._update_health()
            except (OSError, RuntimeError):
                pass
            if self._slos or self._trace:
                try:
                    self._slo_tick()
                except Exception as exc:  # noqa: BLE001 — telemetry only
                    logger.debug("serve client: slo tick failed (%s)", exc)
            self._stop.wait(self._poll_s)

    def _slo_tick(self) -> None:
        """Per-poll SLO/trace bookkeeping: the latency/staleness percentile
        gauges and the per-phase breakdown gauges, one sampling pass of
        this client's own time-series store (the burn-rate evaluation
        lives there), published under the serve-client rank band so the
        trainer's ``bf.ts.<rank>`` keys stay untouched."""
        if self._slos:
            n = min(self._lat_n, _PCT_RING)
            if n:
                w = self._lat_ring[:n]
                _metrics.gauge("slo.request_p50_us").set(
                    float(np.percentile(w, 50)))
                _metrics.gauge("slo.request_p99_us").set(
                    float(np.percentile(w, 99)))
            m = min(self._stal_n, _PCT_RING)
            if m:
                _metrics.gauge("slo.staleness_p99_ver").set(
                    float(np.percentile(self._stal_ring[:m], 99)))
        if self._trace:
            rep = _flight.serve_report()
            if rep:
                for p, st in rep["phases"].items():
                    _metrics.gauge("slo.phase." + p + ".p50_us").set(
                        st["p50_us"])
                    _metrics.gauge("slo.phase." + p + ".p99_us").set(
                        st["p99_us"])
        if self._ts is not None:
            self._publish_ts()

    def _publish_ts(self) -> None:
        from ..runtime import timeseries as _ts

        now = time.time()
        if now - self._ts._last_sample < 0.9:
            return
        self._ts.sample(now)
        interval = max(1.0, self._poll_s)
        if now - self._ts._last_publish < interval:
            return
        rank = _ts.SERVE_TS_RANK_BASE + max(0, self._cid)
        doc = self._ts.build_doc(rank, 0, now, interval)
        try:
            self._cl.put_bytes(_ts.TS_KEY_FMT.format(rank=rank),
                               _ts.pack_doc(doc))
            # unlike the trainer band, an empty blob is written on clear
            # so a consumer can see the alert lifecycle end
            self._cl.put_bytes(
                _ts.ALERTS_KEY_FMT.format(rank=rank),
                zlib.compress(json.dumps(doc["alerts"]).encode())
                if doc["alerts"] else b"")
            self._ts._last_publish = now
        except (OSError, RuntimeError):
            pass

    def _update_health(self) -> None:
        if hasattr(self._cl, "poll_shard_health"):
            # drives the router's dead -> rejoined -> adopt-new-address
            # cycle; without a periodic probe a shard that moved ports
            # would stay dead in this client's view forever
            self._cl.poll_shard_health()
        h: dict = {}
        ts = _snap._get_float(self._cl, _snap.PUB_TS_KEY)
        h["publish_lag_s"] = max(0.0, time.time() - ts) if ts > 0 else None
        h["mailbox_frac"] = self._mailbox_frac()
        h["alerts"] = self._alert_count()
        self._health = h
        if self._cid >= 0:
            _snap._put_float(
                self._cl, _snap.CLIENT_HB_FMT.format(cid=self._cid),
                time.time())

    def _mailbox_frac(self) -> float:
        cap = self._mailbox_cap
        if cap is None:
            # the serving process publishes (cap + 1) at startup; fall
            # back to this process's own knob when it predates the key
            try:
                v = int(self._cl.get("bf.cp.mailbox_cap_bytes"))
            except (OSError, RuntimeError):
                v = 0
            if v > 0:
                cap = v - 1
            else:
                from ..runtime.control_plane import mailbox_cap_bytes
                cap = mailbox_cap_bytes()
            self._mailbox_cap = cap
        if cap <= 0:
            return 0.0
        worst = 0
        if hasattr(self._cl, "server_stats_all"):
            for _, st in self._cl.server_stats_all():
                if st:
                    worst = max(worst, int(st.get("mailbox_bytes", 0)))
        else:
            st = self._cl.server_stats()
            worst = int(st.get("mailbox_bytes", 0)) if st else 0
        return worst / float(cap)

    def _alert_count(self) -> int:
        from ..runtime.timeseries import ALERTS_KEY_FMT

        try:
            world = max(1, int(self._cl.get("bf.metrics.world")))
        except (OSError, RuntimeError):
            return 0
        n = 0
        for r in range(min(world, 64)):
            try:
                blob = self._cl.get_bytes(ALERTS_KEY_FMT.format(rank=r))
            except (OSError, RuntimeError):
                continue
            if not blob:
                continue
            try:
                n += len(json.loads(zlib.decompress(bytes(blob))))
            except (ValueError, zlib.error):
                n += 1  # an unreadable alert blob still counts as one
        return n

    # -- admission + batching ----------------------------------------------

    def admission(self) -> Tuple[str, str]:
        """(verdict, reason): ``accept`` | ``queue`` | ``shed``."""
        depth = self._q.qsize()
        if depth >= self._qmax:
            return "shed", "queue_full"
        h = self._health
        if h.get("mailbox_frac", 0.0) > 0.8:
            return "shed", "mailbox"
        if not self._ready.is_set():
            return "queue", "not_ready"
        if depth >= self._qsoft:
            return "queue", "queue_depth"
        lag = h.get("publish_lag_s")
        if lag is not None and lag > self._stale_s:
            return "queue", "publish_lag"
        if h.get("alerts", 0) > 0:
            return "queue", "alerts"
        return "accept", ""

    def submit(self, example) -> Future:
        """Admit one example (array-like); the future resolves to its model
        output as a numpy row.

        Raises :class:`RequestShed` when the gate sheds. A ``queue``
        verdict still admits (counted in ``stats()['queued']``)."""
        if self._model_fn is None:
            raise RuntimeError("ServeClient was built without a model_fn")
        rec, tid, t0 = self._rec, 0, time.perf_counter()
        if rec is not None:
            tid = (self._tid_base
                   + next(self._tid_iter)) & 0x7FFFFFFFFFFFFFFF
            self._m_traced.inc()
            rec.rec(_flight.SPAN_B, self._nid["serve.req"], 0.0, tid)
            rec.rec(_flight.SPAN_B, self._nid["serve.admit"], 0.0, tid)
        verdict, reason = self.admission()
        if rec is not None:
            rec.rec(_flight.SPAN_E, self._nid["serve.admit"],
                    _ADMIT_CODE.get(verdict, -1.0), tid)
        if verdict == "shed":
            self._bump("shed")
            self._slo_shed()
            if rec is not None:
                rec.rec(_flight.SPAN_E, self._nid["serve.req"], -1.0, tid)
            raise RequestShed(
                f"request shed by admission control ({reason})", reason)
        fut: Future = Future()
        if rec is not None:
            rec.rec(_flight.SPAN_B, self._nid["serve.queue"], 0.0, tid)
        try:
            self._q.put_nowait((np.asarray(example), fut, tid, t0))
        except _queue.Full:
            self._bump("shed")
            self._slo_shed()
            if rec is not None:
                rec.rec(_flight.SPAN_E, self._nid["serve.queue"], 0.0, tid)
                rec.rec(_flight.SPAN_E, self._nid["serve.req"], -1.0, tid)
            raise RequestShed("request shed by admission control "
                              "(queue_full)", "queue_full") from None
        self._bump("queued" if verdict == "queue" else "accepted")
        self._bump("requests")
        return fut

    def _slo_shed(self) -> None:
        if not self._slos:
            return
        self._m_req.inc()
        self._m_shed.inc()
        b = self._m_breach.get("serve_avail")
        if b is not None:
            b.inc()

    def _slo_done(self, t0: float, ver: int) -> None:
        if not self._slos:
            return
        lat_us = (time.perf_counter() - t0) * 1e6
        stale = float(max(0, self._fence_ver - ver))
        self._lat_ring[self._lat_n % _PCT_RING] = lat_us
        self._lat_n += 1
        self._stal_ring[self._stal_n % _PCT_RING] = stale
        self._stal_n += 1
        self._m_req.inc()
        self._m_lat_h.observe(lat_us)
        self._m_stal_h.observe(stale)
        for o in self._slos:
            if o.name in ("serve_p50", "serve_p99"):
                if lat_us > o.target:
                    self._m_breach[o.name].inc()
            elif o.name == "serve_staleness" and stale > o.target:
                self._m_breach[o.name].inc()

    def infer(self, example, timeout: Optional[float] = None) -> np.ndarray:
        """``submit`` + block on the result."""
        return self.submit(example).result(timeout)

    def _trace_dequeue(self, item) -> None:
        rec = self._rec
        if rec is None:
            return
        tid = item[2]
        rec.rec(_flight.SPAN_E, self._nid["serve.queue"], 0.0, tid)
        rec.rec(_flight.SPAN_B, self._nid["serve.linger"], 0.0, tid)

    def _batch_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
            stream = torch.cuda.stream(self._run_stream)
        else:
            stream = contextlib.nullcontext()
        with stream, torch.inference_mode():
            while not self._stop.is_set():
                self._serve_one_batch()

    def _serve_one_batch(self) -> None:
        if not self._ready.wait(timeout=self._poll_s):
            return
        try:
            first = self._q.get(timeout=self._poll_s)
        except _queue.Empty:
            return
        self._trace_dequeue(first)
        batch = [first]
        deadline = time.monotonic() + self._linger_s
        while len(batch) < self._batch_max:
            left = deadline - time.monotonic()
            try:
                item = self._q.get(
                    timeout=max(0.0, left)) if left > 0 \
                    else self._q.get_nowait()
            except _queue.Empty:
                break
            self._trace_dequeue(item)
            batch.append(item)
        with self._mu:
            params = self._params
            served_ver = self._version
        rec = self._rec
        if rec is not None:
            for _, _, tid, _ in batch:
                rec.rec(_flight.SPAN_E, self._nid["serve.linger"],
                        0.0, tid)
                rec.rec(_flight.SPAN_B, self._nid["serve.decode"],
                        0.0, tid)
        try:
            xs = torch.from_numpy(np.stack([x for x, _, _, _ in batch]))
            if self._device.type != "cpu":
                xs = xs.to(self._device)
            # one device-to-host copy per batch, inside the decode span:
            # the span ends when the answers exist
            ys = _to_host(self._model_fn(params, xs))
        except Exception as exc:  # noqa: BLE001 — fail the futures
            for _, fut, tid, _ in batch:
                if not fut.done():
                    fut.set_exception(exc)
                if rec is not None:
                    rec.rec(_flight.SPAN_E, self._nid["serve.decode"],
                            -1.0, tid)
                    rec.rec(_flight.SPAN_E, self._nid["serve.req"],
                            -1.0, tid)
            return
        if rec is not None:
            for _, _, tid, _ in batch:
                rec.rec(_flight.SPAN_E, self._nid["serve.decode"],
                        0.0, tid)
        self._bump("batches")
        for i, (_, fut, tid, t0) in enumerate(batch):
            if not fut.done():
                fut.set_result(ys[i])
            if rec is not None:
                # span-end `a` = the answering snapshot version: the
                # lineage link every consumer resolves through
                rec.rec(_flight.SPAN_E, self._nid["serve.req"],
                        float(served_ver), tid)
            self._slo_done(t0, served_ver)

    # -- observability -----------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_mu:
            self._stats[key] += n

    def stats(self) -> dict:
        with self._stats_mu:
            out = dict(self._stats)
        out["version"] = self.version()
        out["queue_depth"] = self._q.qsize()
        out["publish_lag_s"] = self._health.get("publish_lag_s")
        out["staleness_ver"] = max(0, self._fence_ver - out["version"])
        return out


def serve_client(model_fn: Optional[Callable] = None,
                 endpoints: Optional[Sequence[Tuple[str, int]]] = None,
                 **kw) -> ServeClient:
    """Attach a :class:`ServeClient` to the job's control plane.

    Endpoint resolution mirrors ``--status``: explicit ``endpoints``, else
    ``BFT_CP_HOSTS``, else ``BFT_CP_HOST``/``BFT_CP_PORT``. The secret
    defaults to ``BFT_CP_SECRET``; ``device`` (a keyword) defaults to the
    current CUDA device.
    """
    if endpoints is None:
        from ..runtime.router import parse_endpoints

        spec = knob_env("BFT_CP_HOSTS")
        if spec:
            endpoints = parse_endpoints(spec)
        else:
            host = knob_env("BFT_CP_HOST")
            port = knob_env("BFT_CP_PORT")
            if not host or not port:
                raise RuntimeError(
                    "serve_client: control-plane address unknown; pass "
                    "endpoints=[(host, port)] or set BFT_CP_HOSTS / "
                    "BFT_CP_HOST+BFT_CP_PORT")
            endpoints = [(host, int(port))]
    kw.setdefault("secret", knob_env("BFT_CP_SECRET") or "")
    return ServeClient(endpoints, model_fn, **kw)
