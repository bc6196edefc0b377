"""``bfrun``'s attach modes for jobs of the port.

Counterpart of ``bluefog_tpu/launcher.py``'s external views: ``--status``
(the cluster-health view, ``--strict`` to gate on its findings), ``--top``
(the live dashboard over the streamed time series), ``--dump`` (a
cluster-wide flight-recorder dump retrieved over the control plane) and
``--serve`` (a read-only serve client that mirrors the job's snapshots,
and with ``--serve-model MODULE:FN`` serves batched inference). Each is a
raw control-plane client that reaches a running job from outside it: no
process group, no membership registration.

    python -m bluefog_tpu_torch.launcher --status [--strict] --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --top [--once] --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --dump --out DIR --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --serve [--once] [--device cpu]

The address is ``--cp``, else ``BFT_CP_HOSTS``, else ``BFT_CP_HOST`` and
``BFT_CP_PORT``, else ``torchrun``'s ``MASTER_ADDR`` and ``MASTER_PORT +
17`` (the port's attach convention, where the JAX package reads
``JAX_COORDINATOR_ADDRESS``). The parser is the JAX launcher's, flag for
flag; launching a program (``-np``, ``-H``, ``--simulate``, ``--elastic``,
``--chaos`` with a command) is not ported yet (ROADMAP Queue 1, item 9):
the port's jobs start under ``torchrun``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional, Tuple

from .runtime.config import knob_env


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bfrun",
        description="Attach to a running bluefog_tpu_torch job (--status, "
                    "--top, --dump, --serve). Launching a program is not "
                    "ported yet: run it under torchrun.",
    )
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of processes (multi-host); default: "
                        "single-process using all local devices")
    p.add_argument("--coordinator", type=str, default=None,
                   help="coordinator address host:port of a multi-host "
                        "launch (required when -np > 1)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's process index (multi-host)")
    p.add_argument("-H", "--hosts", type=str, default=None,
                   help="comma-separated host:slots list (e.g. "
                        "'host1:1,host2:1'); the driver launches every "
                        "process itself (reference run.py -H)")
    p.add_argument("--hostfile", type=str, default=None,
                   help="file with one 'host slots=N' (or 'host:N' or bare "
                        "'host') line per host (reference run.py --hostfile)")
    p.add_argument("--ssh-port", type=int, default=22,
                   help="ssh port for remote fan-out (reference --ssh-port)")
    p.add_argument("--remote-python", type=str, default="python3",
                   help="python executable to run on remote hosts")
    p.add_argument("--simulate", type=int, default=None, metavar="N",
                   help="simulate an N-device CPU mesh (development)")
    p.add_argument("--elastic", nargs="?", const=3, type=int, default=None,
                   metavar="MAX_RESTARTS",
                   help="supervise children elastically: a crashed rank is "
                        "respawned with BFT_INCARNATION bumped (the "
                        "control plane fences its zombie and the rank "
                        "rejoins through quarantined state transfer, see "
                        "docs/fault_tolerance.md), up to MAX_RESTARTS per "
                        "rank (default 3) with exponential backoff. A "
                        "terminal failure propagates only when a rank's "
                        "restart budget is exhausted or the surviving "
                        "world would drop below --min-world")
    p.add_argument("--min-world", type=int, default=1, metavar="M",
                   help="with --elastic: kill the whole job once fewer "
                        "than M ranks could keep running (default 1)")
    p.add_argument("--cp-shards", type=int, default=None, metavar="N",
                   help="shard the control plane across N server processes "
                        "(failover-capable: clients route keys with a "
                        "stable hash and fail over when a shard dies; "
                        "membership state is replicated on every shard — "
                        "docs/fault_tolerance.md). In driver (-H/--hostfile)"
                        " mode the driver launches N shard servers and "
                        "exports BFT_CP_HOSTS to every process; "
                        "otherwise exports BFT_CP_SHARDS and rank 0 "
                        "serves all N in-process")
    p.add_argument("--chaos", type=str, default=None, metavar="SPEC",
                   help="arm deterministic control-plane fault injection in "
                        "every launched process (exports BFT_CP_FAULT; "
                        "spec e.g. 'drop_after=37,delay_ms=50,trunc=1,"
                        "seed=7' — see docs/fault_tolerance.md). Testing "
                        "only: never set on a production job")
    p.add_argument("--status", action="store_true",
                   help="print the job's cluster-health view (per-rank "
                        "step counters, staleness, stragglers, push-sum "
                        "mass conservation) from the control-plane KV and "
                        "exit — works from OUTSIDE the job as long as "
                        "BFT_CP_HOST/PORT (or --cp) and, for "
                        "authenticated jobs, BFT_CP_SECRET are set. "
                        "Ranks publish snapshots on the "
                        "BFT_METRICS_INTERVAL cadence (docs/metrics.md)")
    p.add_argument("--strict", action="store_true",
                   help="with --status: exit non-zero (2) when the health "
                        "view shows findings — dead/stale ranks, "
                        "stragglers, or push-sum mass drift — so CI and "
                        "operator scripts can gate on cluster health; the "
                        "default stays exit 0 regardless of findings")
    p.add_argument("--top", action="store_true",
                   help="live cluster dashboard over the streamed "
                        "time-series plane (`bf.ts.<rank>`, "
                        "docs/observability.md): per-rank step cadence, "
                        "consensus distance + mixing rate, mass, EF "
                        "residual, shard drift, sparklines, active "
                        "alerts, and a per-edge bytes/s + transit-latency "
                        "matrix — refreshed in place every --interval "
                        "seconds from OUTSIDE the job (raw control-plane "
                        "client, no mesh join). Silent ranks (SIGKILLed/"
                        "wedged — no publication within 3 intervals) are "
                        "named")
    p.add_argument("--interval", type=float, default=2.0, metavar="SEC",
                   help="with --top: refresh cadence (default 2 s)")
    p.add_argument("--once", action="store_true",
                   help="with --top: render one frame to stdout and exit "
                        "(no screen clearing — scripts/CI friendly)")
    p.add_argument("--world", type=int, default=0, metavar="N",
                   help="with --top: expected rank count (default: the "
                        "bf.metrics.world hint, then BFT_CP_WORLD, "
                        "then a heartbeat-key scan) — ranks missing from "
                        "it are reported SILENT")
    p.add_argument("--dump", action="store_true",
                   help="trigger a cluster-wide flight-recorder dump: bump "
                        "the KV flag every rank's heartbeat/watchdog tick "
                        "polls, wait for acks, retrieve each rank's packed "
                        "ring tail over the control plane (no filesystem "
                        "access to any worker needed), and write per-rank "
                        "dumps plus a merged clock-synced chrome trace "
                        "under --out (docs/flight_recorder.md)")
    p.add_argument("--out", type=str, default="bf_flight_dump",
                   metavar="DIR",
                   help="output directory for --dump (default "
                        "bf_flight_dump/)")
    p.add_argument("--dump-timeout", type=float, default=60.0,
                   metavar="SEC",
                   help="how long --dump waits for rank acks (ranks poll "
                        "the trigger on their heartbeat cadence, default "
                        "5 s, so the default 60 covers slow ticks)")
    p.add_argument("--serve", action="store_true",
                   help="attach a read-only serving client to the job's "
                        "snapshot plane (docs/serving.md): pull the "
                        "current versioned snapshot, hot-swap on every "
                        "fence bump, and print one line per swap "
                        "(version, wire bytes, pull MB/s, publish lag) "
                        "until Ctrl-C. Works from OUTSIDE the job like "
                        "--status: raw control-plane client, no "
                        "process group. With --once: exit after the first "
                        "complete snapshot (0) or --serve-timeout (1)")
    p.add_argument("--serve-model", type=str, default=None,
                   metavar="MODULE:FN",
                   help="with --serve: import FN from MODULE as "
                        "model_fn(params, batch) and serve batched "
                        "inference behind the admission gate instead of "
                        "only mirroring snapshots")
    p.add_argument("--serve-timeout", type=float, default=30.0,
                   metavar="SEC",
                   help="with --serve: how long to wait for the first "
                        "complete snapshot before giving up (default 30)")
    p.add_argument("--cp", type=str, default=None,
                   metavar="HOST:PORT[,HOST:PORT...]",
                   help="control-plane address(es) for --status/--dump — "
                        "a sharded job names every shard, and the views "
                        "are merged with dead shards reported by name "
                        "(default: BFT_CP_HOSTS, then "
                        "BFT_CP_HOST/BFT_CP_PORT, falling back to "
                        "MASTER_ADDR and MASTER_PORT + 17)")
    p.add_argument("--device", type=str, default="cuda",
                   help="with --serve: the device the client serves on "
                        "(default: the card; cpu serves on the host)")
    p.add_argument("--timeline-filename", type=str, default=None,
                   help="enable the timeline profiler, writing to this prefix")
    p.add_argument("--verbose", action="store_true",
                   help="debug logging (BFT_LOG_LEVEL=debug)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="program and arguments to run")
    return p



def _cp_address(args, what: str):
    """Resolve the control-plane endpoint list for --status/--dump: --cp
    wins (``HOST:PORT[,HOST:PORT...]`` — a sharded job names every shard),
    then BFT_CP_HOSTS, then BFT_CP_HOST/PORT, then ``torchrun``'s
    MASTER_ADDR and MASTER_PORT + 17 (the port's attach convention).
    Returns [(host, port)] or None after printing the error."""
    from .runtime.control_plane import PORT_OFFSET
    from .runtime.router import parse_endpoints

    spec = args.cp or knob_env("BFT_CP_HOSTS")
    if spec:
        try:
            eps = parse_endpoints(spec)
        except ValueError as exc:
            print(f"bfrun {what}: {exc}", file=sys.stderr)
            return None
        if eps:
            return eps
    host = knob_env("BFT_CP_HOST")
    port = knob_env("BFT_CP_PORT")
    if host is None or port is None:
        maddr = os.environ.get("MASTER_ADDR")
        mport = os.environ.get("MASTER_PORT")
        if maddr and mport:
            host = host or maddr
            port = port or int(mport) + PORT_OFFSET
    if not host or not port:
        print(f"bfrun {what}: control-plane address unknown; pass "
              "--cp HOST:PORT[,HOST:PORT...] or set "
              "BFT_CP_HOST/BFT_CP_PORT (or BFT_CP_HOSTS)",
              file=sys.stderr)
        return None
    return [(host, port)]


def _raw_client(endpoints, what: str):
    """A raw read-only attachment for --status/--dump: a plain client for
    one endpoint, a LENIENT ShardRouter for several (a dead shard is
    reported by name in the output instead of failing the probe)."""
    from .runtime.native import ControlPlaneClient
    from .runtime.router import ShardRouter

    secret = knob_env("BFT_CP_SECRET") or ""
    try:
        if len(endpoints) == 1:
            host, port = endpoints[0]
            return ControlPlaneClient(host, port, 0, secret=secret,
                                      streams=1)
        return ShardRouter(endpoints, 0, secret=secret, streams=1,
                           lenient=True)
    except (OSError, RuntimeError) as exc:
        names = ",".join(f"{h}:{p}" for h, p in endpoints)
        print(f"bfrun {what}: cannot reach the control plane at "
              f"{names} ({exc})", file=sys.stderr)
        return None


def _report_dead_shards(cl, what: str) -> list:
    """Print (never raise) the router's dead-shard view; [] for a plain
    single-endpoint client."""
    if not hasattr(cl, "dead_shard_endpoints"):
        return []
    dead = cl.dead_shard_endpoints()
    for name in dead:
        print(f"bfrun {what}: control-plane shard {name} is DEAD "
              "(its keyspace failed over; routed state there is lost)",
              file=sys.stderr)
    return dead


def _strict_findings(health: dict) -> List[str]:
    """Health findings that make ``--status --strict`` exit non-zero."""
    findings: List[str] = []
    dead = sorted(p for p, r in health["ranks"].items() if not r["alive"])
    if dead:
        findings.append(f"stale/dead rank(s): {dead}")
    if health["stragglers"]:
        findings.append(f"straggler(s): {health['stragglers']}")
    m = health.get("mass")
    if m is not None and not m["conserved"]:
        findings.append(
            f"push-sum mass drift {m['drift']:.3g} exceeds tolerance "
            f"{m['tolerance']:.3g}")
    repl = health.get("repl")
    if repl is not None and repl["under_replicated"]:
        findings.append(
            f"{repl['under_replicated']} control-plane shard(s) "
            "under-replicated (heartbeat-published cp.under_replicated "
            "gauge)")
    return findings


def _shard_drift_findings(cl, world: int) -> List[str]:
    """SUSTAINED shard-rotation drift per rank, from the streamed
    ``win.shard_stale_drops.rate`` series (a lone historical drop is not
    a finding; three consecutive positive rate samples are — a
    controller's comm-round counter desynced and every one of its
    deposits is being discarded; docs/sharded_windows.md)."""
    from .runtime import timeseries as _ts

    findings: List[str] = []
    acc = _ts.HistoryAccumulator()
    for r in range(world):
        doc = _ts.read_rank(cl, r)
        if doc:
            acc.update(r, doc)
    for r in range(world):
        vals = acc.values(r, "win.shard_stale_drops.rate", last=8)
        tail = [v for v in vals[-3:]]
        if len(tail) >= 3 and all(v > 0 for v in tail):
            findings.append(
                f"rank {r}: sustained shard-rotation drift "
                f"({tail[-1]:.2f} stale drops/s across the last "
                f"{len(tail)} samples)")
    return findings


def _slo_budget_findings(cl) -> List[str]:
    """Exhausted serving error budgets for ``--status --strict``: any
    live serve client whose published ``slo.budget.<kind>`` gauge is at
    or below zero has burned its whole window budget (docs/slo.md)."""
    from .runtime import timeseries as _ts
    from .serving import snapshot as _snap

    findings: List[str] = []
    try:
        cids = _snap.live_client_ids(cl)
    except (OSError, RuntimeError):
        return findings
    acc = _ts.HistoryAccumulator()
    for cid in cids:
        r = _ts.SERVE_TS_RANK_BASE + cid
        doc = _ts.read_rank(cl, r)
        if doc is None:
            continue
        acc.update(r, doc)
        for (rank, name) in sorted(acc.series):
            if rank != r or not name.startswith("slo.budget."):
                continue
            v = acc.latest(r, name)
            if v is not None and v <= 0.0:
                kind = name[len("slo.budget."):]
                findings.append(
                    f"serve client {cid}: {kind} SLO error budget "
                    f"exhausted ({v * 100:.1f}% remaining over the slow "
                    "burn window — docs/slo.md)")
    return findings


def _status(args) -> int:
    """``bfrun --status``: the cluster-health view from outside the job.

    Reads the packed per-rank snapshots the controllers publish under
    ``bf.metrics.<rank>`` (runtime/metrics.py) over a plain control-plane
    connection — no process group, no membership registration, no job
    interference (scalar gets only). ``--strict`` turns findings into a
    non-zero exit (2) for CI/operator scripting; the default exit stays 0
    so dashboards polling a degraded job never mistake findings for a
    broken probe."""
    addr = _cp_address(args, "--status")
    if addr is None:
        return 1
    from .runtime import metrics as _metrics

    cl = _raw_client(addr, what="--status")
    if cl is None:
        return 1
    try:
        health = _metrics.read_cluster_health(cl)
        print(_metrics.format_health(health))
        if not health["ranks"]:
            print("  (no rank has published metrics — is "
                  "BFT_METRICS_INTERVAL set on the job?)")
        dead_shards = []
        under_replicated = []
        below_quorum = []
        if hasattr(cl, "server_stats_all"):
            # sharded plane: merge the per-shard server views; a dead
            # shard is a named row, never a raised probe failure
            print(f"  control-plane shards ({cl.shard_count}):")
            for name, st in cl.server_stats_all():
                if st is None:
                    print(f"    {name}: DEAD")
                    dead_shards.append(name)
                else:
                    repl = {0: "off", 1: "live", 2: "DEGRADED"}.get(
                        st.get("repl_status", 0), "?")
                    lag = st.get("wal_enqueued", 0) - st.get("wal_acked", 0)
                    # quorum replication (r20): replicas = this shard's
                    # copy count (itself + live successor streams);
                    # quorum=LOST marks a shard serving read-only behind
                    # the typed QuorumLostError gate
                    quorum = {0: "n/a", 1: "held", 2: "LOST"}.get(
                        st.get("quorum_state", 0), "?")
                    replicas = 1 + int(st.get("repl_targets_live", 0))
                    print(f"    {name}: conns={st['live_connections']} "
                          f"kv={st['kv_entries']} "
                          f"mailbox={st['mailbox_records']} recs/"
                          f"{st['mailbox_bytes']} B "
                          f"locks={st['locks_held']} "
                          f"stale_rejects={st['stale_rejects']} "
                          f"repl={repl} wal_lag={lag} "
                          f"wal_dropped={st.get('wal_dropped', 0)} "
                          f"replicas={replicas} quorum={quorum} "
                          f"quorum_acks={st.get('quorum_acks', 0)} "
                          f"replica_sources="
                          f"{st.get('replica_sources', 0)} "
                          f"partition_rejects="
                          f"{st.get('partition_rejects', 0)}")
                    if st.get("repl_status", 0) == 2:
                        # successor lagging/absent: this shard is serving
                        # acked writes that live NOWHERE else
                        under_replicated.append(name)
                    if st.get("quorum_state", 0) == 2:
                        below_quorum.append(name)
        serve_lines, serve_st = _serve_status_lines(cl)
        for line in serve_lines:
            print(line)
        if getattr(args, "strict", False):
            findings = _strict_findings(health)
            findings.extend(
                _shard_drift_findings(cl, health["world"]))
            findings.extend(_slo_budget_findings(cl))
            if serve_st is not None:
                lag = serve_st.get("publish_lag_s")
                stale_s = float(knob_env("BFT_SERVE_STALE_S"))
                if lag is not None and lag > stale_s:
                    findings.append(
                        f"stale serving snapshot: v{serve_st['version']} "
                        f"published {lag:.1f} s ago (threshold "
                        f"BFT_SERVE_STALE_S={stale_s:g} s — the "
                        "publisher hook stopped or the trainer is down)")
            if dead_shards:
                findings.append(
                    f"dead control-plane shard(s): {dead_shards}")
            if under_replicated:
                findings.append(
                    "under-replicated control-plane shard(s) (WAL "
                    f"degraded, successor lagging or absent): "
                    f"{under_replicated}")
            if below_quorum:
                # an UNHEALED partition shows up exactly here: every
                # shard the cut isolated from its commit quorum stays in
                # quorum=LOST until the cut heals (a healed one leaves
                # only the cp.partitions counter trail, which is history,
                # not a finding)
                findings.append(
                    "control-plane shard(s) below commit quorum — "
                    "unhealed partition or too many replica deaths "
                    "(mutating ops rejected with QuorumLostError): "
                    f"{below_quorum}")
            if findings:
                for f in findings:
                    print(f"  STRICT: {f}", file=sys.stderr)
                return 2
    finally:
        cl.close()
    return 0


def _serve_status_lines(cl) -> Tuple[List[str], Optional[dict]]:
    """The serving-plane rows for ``--status`` (empty when the job never
    published a snapshot — serving is opt-in via
    BFT_SERVE_PUBLISH_EVERY)."""
    from .serving.snapshot import read_serve_status

    try:
        st = read_serve_status(cl)
    except (OSError, RuntimeError):
        return [], None
    if not st:
        return [], None
    lag = st.get("publish_lag_s")
    lag_txt = f"published {lag:.1f} s ago" if lag is not None \
        else "publish time unknown"
    lines = [
        "  serving plane (docs/serving.md):",
        f"    snapshot v{st['version']} (step {st['pub_step']}), "
        f"{lag_txt}, {st['shards']} stripe(s), "
        f"gc floor v{st['gc_floor']}",
        f"    serve clients: {st['clients_live']}/{st['clients_total']} "
        "heartbeating",
    ]
    return lines, st


def _serve(args) -> int:
    """``bfrun --serve``: attach a read-only serving client from OUTSIDE
    the job (docs/serving.md).

    Like --status this is a raw control-plane attachment — no process
    group, no membership registration — so it runs on an inference host
    that shares nothing with the trainer but the control-plane address.
    The client pulls the committed snapshot onto ``--device``, hot-swaps on
    every fence bump, and prints one line per swap; --serve-model
    MODULE:FN additionally serves batched inference behind the admission
    gate."""
    addr = _cp_address(args, "--serve")
    if addr is None:
        return 1
    model_fn = None
    if args.serve_model:
        import importlib

        mod_name, _, fn_name = args.serve_model.partition(":")
        fn_name = fn_name or "model_fn"
        try:
            model_fn = getattr(importlib.import_module(mod_name), fn_name)
        except (ImportError, AttributeError) as exc:
            print(f"bfrun --serve: cannot load --serve-model "
                  f"{args.serve_model!r} ({exc})", file=sys.stderr)
            return 1
    from .serving.client import ServeClient

    sc = ServeClient(addr, model_fn, secret=knob_env("BFT_CP_SECRET") or "",
                     device=args.device)
    try:
        if not sc.wait_ready(timeout=args.serve_timeout):
            st = sc.stats()
            print(f"bfrun --serve: no complete snapshot within "
                  f"{args.serve_timeout:g} s "
                  f"({st['pull_failures']} pull failure(s)) — is the "
                  "trainer publishing (BFT_SERVE_PUBLISH_EVERY)?",
                  file=sys.stderr)
            return 1
        last = 0
        while True:
            ver = sc.version()
            if ver > last:
                last = ver
                st = sc.stats()
                lag = st.get("publish_lag_s")
                lag_txt = f"{lag:.1f}" if lag is not None else "?"
                print(f"bfrun --serve: snapshot v{ver} "
                      f"({st['wire_bytes'] / 1e6:.1f} MB wire total, "
                      f"{st.get('pull_mbps', 0.0):.0f} MB/s, "
                      f"publish lag {lag_txt} s, "
                      f"{st['swaps']} swap(s))", flush=True)
                if args.once:
                    return 0
            time.sleep(0.2)
    except KeyboardInterrupt:
        return 0
    finally:
        sc.close()


def _discover_world(cl) -> int:
    """World size for the external consumers: the published hint, the
    env, then a heartbeat-key scan (the --dump convention)."""
    world = 0
    try:
        world = int(cl.get("bf.metrics.world"))
    except (OSError, RuntimeError):
        pass
    if world <= 0:
        try:
            world = int(knob_env("BFT_CP_WORLD") or 0)
        except ValueError:
            world = 0
    if world <= 0:
        world = 1
        for r in range(256):
            try:
                if int(cl.get(f"bf.hb.{r}")) == 0 and r > 0:
                    break
            except (OSError, RuntimeError):
                break
            world = r + 1
    return world


def _format_tune_section(cl, world: int) -> str:
    """Render the self-tuner decision trail (``bf.tune.<rank>``) for the
    ``--top`` frame: active per-edge codec levels, demoted ranks, and
    the most recent decisions across the fleet. Empty string when no
    rank has published (BFT_TUNE off — the common case)."""
    import json as _json

    from .runtime import tuner as _tuner

    levels: dict = {}
    demoted: dict = {}
    recent: list = []
    for r in range(world):
        try:
            blob = cl.get_bytes(_tuner.TUNE_KEY_FMT.format(rank=r))
        except (OSError, RuntimeError):
            continue
        if not blob:
            continue
        try:
            doc = _json.loads(bytes(blob).decode())
        except (ValueError, UnicodeDecodeError):
            continue
        levels.update(doc.get("levels") or {})
        demoted.update(doc.get("demoted") or {})
        for d in doc.get("decisions") or []:
            recent.append((d.get("t", 0.0), r, d))
    if not levels and not demoted and not recent:
        return ""
    lines = ["  SELF-TUNER (docs/self_tuning.md)"]
    if levels:
        terms = ", ".join(f"{e}={c}" for e, c in sorted(levels.items()))
        lines.append(f"    edge codecs: {terms}")
    if demoted:
        terms = ", ".join(
            f"rank {p} (-{len(v)} in-edges)"
            for p, v in sorted(demoted.items(), key=lambda kv: int(kv[0])))
        lines.append(f"    demoted: {terms}")
    for t, r, d in sorted(recent, key=lambda x: (x[0], x[1]),
                          reverse=True)[:5]:
        tgt = d.get("target")
        if isinstance(tgt, list):
            tgt = f"{tgt[0]}>{tgt[1]}"
        lines.append(
            f"    [{d.get('status', '?'):>8}] r{r} {d.get('lever')} "
            f"{d.get('action')} {tgt} {d.get('arg') or ''} "
            f"— {d.get('reason', '')}")
    return "\n".join(lines)


def _format_slo_section(acc, cids) -> str:
    """Render the serving SLO view for the ``--top`` frame: per-client
    error-budget gauges, fast/slow burn rates, and per-phase request
    latency percentiles from the serve clients' published streams
    (``bf.ts.<SERVE_TS_RANK_BASE + cid>``). Empty string when no client
    declared SLOs or enabled tracing (BFT_SLO/BFT_TRACE_SERVE
    unset — the common case)."""
    from .runtime import flight as _flight
    from .runtime import timeseries as _ts

    lines: List[str] = []
    for cid in cids:
        r = _ts.SERVE_TS_RANK_BASE + cid
        budgets = sorted(
            name for (rank, name) in acc.series
            if rank == r and name.startswith("slo.budget."))
        p50 = acc.latest(r, "slo.request_p50_us")
        p99 = acc.latest(r, "slo.request_p99_us")
        if not budgets and p99 is None:
            continue
        active = {a.get("name") for a in acc.alerts.get(r, [])
                  if str(a.get("name", "")).startswith("slo.")}
        rate = acc.latest(r, "slo.requests.rate")
        shed = acc.latest(r, "slo.shed.rate")
        head = f"    client {cid}:"
        if rate is not None:
            head += f" {rate:.1f} req/s"
            if shed:
                head += f" ({shed:.1f} shed/s)"
        if p99 is not None:
            head += (f" | req p50/p99 {p50 or 0:.0f}/{p99:.0f} us")
        stale = acc.latest(r, "slo.staleness_p99_ver")
        if stale is not None:
            head += f" | staleness p99 {stale:.0f} ver"
        lines.append(head)
        for name in budgets:
            kind = name[len("slo.budget."):]
            budget = acc.latest(r, name)
            fast = acc.latest(r, f"slo.burn.{kind}.fast") or 0.0
            slow = acc.latest(r, f"slo.burn.{kind}.slow") or 0.0
            if budget is None:
                continue
            if budget <= 0.0:
                flag = "EXHAUSTED"
            elif f"slo.{kind}" in active:
                flag = "BURNING"
            else:
                flag = "ok"
            lines.append(
                f"      {kind}: budget {budget * 100:6.1f}%  "
                f"burn {fast:.2f}x fast / {slow:.2f}x slow  [{flag}]")
        phases = []
        for p in _flight.SERVE_PHASES:
            pp50 = acc.latest(r, f"slo.phase.{p}.p50_us")
            pp99 = acc.latest(r, f"slo.phase.{p}.p99_us")
            if pp99 is not None:
                phases.append(f"{p} {pp50 or 0:.0f}/{pp99:.0f}")
        if phases:
            lines.append("      phases p50/p99 us: " + "  ".join(phases))
    if not lines:
        return ""
    return "\n".join(["  SERVING SLO (docs/slo.md)"] + lines)


def _format_quorum_section(cl, episodes: dict) -> str:
    """The ``--top`` QUORUM line (r20 durability plane): per-shard
    commit-quorum state from ``server_stats_all`` with partition-episode
    start/heal wall-clock timestamps tracked across frames in
    ``episodes`` (shard name -> mutable record). Empty string when the
    plane is unsharded or replication is off (quorum n/a everywhere)."""
    if not hasattr(cl, "server_stats_all"):
        return ""
    try:
        stats = list(cl.server_stats_all())
    except (OSError, RuntimeError):
        return ""
    now = time.time()

    def _hms(t):
        return time.strftime("%H:%M:%S", time.localtime(t))

    held = lost = 0
    terms: List[str] = []
    for name, st in stats:
        ep = episodes.setdefault(
            name, {"state": 0, "since": None, "last": None, "count": 0})
        q = 0 if st is None else int(st.get("quorum_state", 0))
        if q == 2 and ep["state"] != 2:
            ep["since"] = now
            ep["count"] += 1
        elif q != 2 and ep["state"] == 2 and ep["since"] is not None:
            ep["last"] = (ep["since"], now)
            ep["since"] = None
        ep["state"] = q
        if q == 1:
            held += 1
        elif q == 2:
            lost += 1
            rejects = int(st.get("partition_rejects", 0)) if st else 0
            since = _hms(ep["since"]) if ep["since"] else "?"
            terms.append(f"{name}: LOST since {since} "
                         f"({rejects} partition reject(s))")
        if q != 2 and ep["last"] is not None:
            t0, t1 = ep["last"]
            terms.append(f"{name}: healed {_hms(t0)}->{_hms(t1)}")
    if held + lost == 0:
        return ""  # replication off: no quorum plane to report
    line = f"  QUORUM: {held}/{held + lost} shard(s) held"
    if terms:
        line += " | " + " | ".join(terms)
    return line


def _top(args) -> int:
    """``bfrun --top``: the live cluster dashboard.

    Polls every rank's ``bf.ts.<rank>`` delta stream over a raw
    control-plane client (the ``--status`` pattern: no process group, scalar/bytes gets only) and renders the merged view — per-rank
    convergence table with sparklines, active alerts, silent-rank
    detection, and the per-edge bytes/s + transit matrix assembled from
    cross-rank flow matching. ``--once`` renders a single plain frame;
    otherwise the screen refreshes in place every ``--interval``
    seconds until Ctrl-C."""
    import time as _time

    addr = _cp_address(args, "--top")
    if addr is None:
        return 1
    from .runtime import timeseries as _ts

    cl = _raw_client(addr, what="--top")
    if cl is None:
        return 1
    acc = _ts.HistoryAccumulator()
    quorum_eps: dict = {}
    try:
        while True:
            world = args.world or _discover_world(cl)
            for r in range(world):
                doc = _ts.read_rank(cl, r)
                if doc is not None:
                    acc.update(r, doc)
            frame = _ts.format_top(acc, world)
            tune = _format_tune_section(cl, world)
            if tune:
                frame += "\n" + tune
            from .serving import snapshot as _snap
            try:
                cids = _snap.live_client_ids(cl)
            except (OSError, RuntimeError):
                cids = []
            for cid in cids:
                doc = _ts.read_rank(cl, _ts.SERVE_TS_RANK_BASE + cid)
                if doc is not None:
                    acc.update(_ts.SERVE_TS_RANK_BASE + cid, doc)
            slo = _format_slo_section(acc, cids)
            if slo:
                frame += "\n" + slo
            quorum = _format_quorum_section(cl, quorum_eps)
            if quorum:
                frame += "\n" + quorum
            dead = _report_dead_shards(cl, "--top") \
                if hasattr(cl, "dead_shard_endpoints") else []
            if dead:
                frame += f"\n  DEAD control-plane shard(s): {dead}"
            if args.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0
    finally:
        cl.close()


def _dump(args) -> int:
    """``bfrun --dump``: cluster-wide flight-recorder retrieval.

    Bumps the ``bf.flight.trigger`` KV counter; every rank's
    heartbeat/watchdog tick sees it, dumps locally, and publishes its
    packed ring tail under ``bf.flight.<rank>``. This side waits for the
    per-rank acks (bounded by --dump-timeout), pulls the tails over the
    same raw connection, and writes per-rank JSON dumps plus one merged,
    clock-synced chrome trace — postmortem evidence with no filesystem
    access to any worker."""
    import json
    import time as _time

    addr = _cp_address(args, "--dump")
    if addr is None:
        return 1
    from .runtime import flight as _flight

    cl = _raw_client(addr, what="--dump")
    if cl is None:
        return 1
    try:
        trig = int(cl.fetch_add(_flight.TRIGGER_KEY, 1)) + 1
        world = int(cl.get("bf.metrics.world")) or \
            int(knob_env("BFT_CP_WORLD") or 0)
        if world <= 0:
            # no world hint published: scan the heartbeat keys (multi-
            # controller) and fall back to a single-rank probe window
            world = 1
            for r in range(256):
                if int(cl.get(f"bf.hb.{r}")) == 0 and r > 0:
                    break
                world = r + 1
        print(f"bfrun --dump: trigger #{trig} set; waiting for "
              f"{world} rank(s) (timeout {args.dump_timeout:.0f}s)")
        deadline = _time.monotonic() + max(1.0, args.dump_timeout)
        acked: set = set()
        while _time.monotonic() < deadline and len(acked) < world:
            for r in range(world):
                if r not in acked and \
                        int(cl.get(_flight.ACK_KEY_FMT.format(rank=r))) \
                        >= trig:
                    acked.add(r)
            if len(acked) < world:
                _time.sleep(0.25)
        docs = []
        os.makedirs(args.out, exist_ok=True)
        for r in sorted(acked):
            try:
                blob = cl.get_bytes(_flight.DATA_KEY_FMT.format(rank=r))
                doc = _flight.unpack_dump(blob)
            except (OSError, ValueError) as exc:
                print(f"bfrun --dump: rank {r} tail unreadable ({exc})",
                      file=sys.stderr)
                continue
            path = os.path.join(args.out, f"flight_{r}.json")
            with open(path, "w") as f:
                json.dump(doc, f)
            n = len(doc.get("events", {}).get("kind", []))
            print(f"  rank {r}: {n} events "
                  f"(reason: {doc['meta'].get('reason')}) -> {path}")
            docs.append(doc)
        missing = sorted(set(range(world)) - acked)
        if missing:
            print(f"bfrun --dump: no ack from rank(s) {missing} — wedged "
                  "hard (no heartbeat/watchdog tick) or already gone",
                  file=sys.stderr)
        if not docs:
            print("bfrun --dump: no rank published a tail", file=sys.stderr)
            return 1
        merged = _flight.merge_dumps(docs)
        mpath = os.path.join(args.out, "merged.json")
        with open(mpath, "w") as f:
            json.dump(merged, f)
        flows = sum(1 for e in merged if e.get("ph") in ("s", "f"))
        print(f"  merged: {len(merged)} events ({flows} flow events) -> "
              f"{mpath}")
        _report_dead_shards(cl, "--dump")
    finally:
        cl.close()
    return 0




def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.status:
        return _status(args)
    if args.top:
        return _top(args)
    if args.dump:
        return _dump(args)
    if args.serve:
        return _serve(args)
    if not args.command:
        build_parser().print_usage()
        return 1
    raise SystemExit(
        "bfrun: launching a program is not ported to bluefog_tpu_torch yet "
        "(ROADMAP Queue 1, item 9: the launch modes); start the job with "
        "torchrun (torchrun --nproc_per_node N your_script.py) and attach "
        "to it with --status, --top, --dump or --serve")


if __name__ == "__main__":
    sys.exit(main())
