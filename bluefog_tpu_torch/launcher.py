"""``bfrun`` for jobs of the port: launch a program, or attach to a job.

Counterpart of ``bluefog_tpu/launcher.py``, with one process per rank. The
launch modes:

  * exec: export the port's knobs (``--timeline-filename`` ->
    ``BFT_TIMELINE``, ``--verbose`` -> ``BFT_LOG_LEVEL=debug``,
    ``--cp-shards N`` -> ``BFT_CP_SHARDS``, ``--chaos SPEC`` ->
    ``BFT_CP_FAULT`` after ``parse_fault_spec`` has checked it) and exec
    the program;
  * ``-np N --coordinator HOST:PORT --process-id i``: the same, as rank i
    of a world of N, through ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` when the fan-out gives them), which ``bf.init``
    reads. The control plane then listens on ``MASTER_PORT + 17``;
  * ``-H host:slots,...`` or ``--hostfile``: this one command drives the
    whole job — local slots as subprocesses, remote ones over ssh — with
    the coordinator picked, ids assigned, a job secret minted
    (``BFT_CP_SECRET``), exit codes aggregated and the job killed on
    Ctrl-C or at the first failure; ``--cp-shards N`` starts N shard
    servers (``runtime/shard_server.py``) and exports ``BFT_CP_HOSTS``;
    ``--elastic`` respawns a crashed rank with ``BFT_INCARNATION`` raised
    by one;
  * ``--simulate N``: N ranks of this host as N processes on the CPU over
    gloo (``BFT_SIMULATE_DEVICES=N``), where the JAX launcher runs one
    process over N forced CPU devices.

    python -m bluefog_tpu_torch.launcher --timeline-filename /tmp/tl_ -- python train.py
    python -m bluefog_tpu_torch.launcher -H localhost:4 -- python train.py
    python -m bluefog_tpu_torch.launcher --simulate 4 -- python train.py

The attach modes are external views of a running job: ``--status`` (the
cluster-health view, ``--strict`` to gate on its findings), ``--top`` (the
live dashboard over the streamed time series), ``--dump`` (a cluster-wide
flight-recorder dump retrieved over the control plane) and ``--serve`` (a
read-only serve client that mirrors the job's snapshots, and with
``--serve-model MODULE:FN`` serves batched inference). Each is a raw
control-plane client that reaches a running job from outside it: no
process group, no membership registration.

    python -m bluefog_tpu_torch.launcher --status [--strict] --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --top [--once] --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --dump --out DIR --cp HOST:PORT
    python -m bluefog_tpu_torch.launcher --serve [--once] [--device cpu]

Their address is ``--cp``, else ``BFT_CP_HOSTS``, else ``BFT_CP_HOST`` and
``BFT_CP_PORT``, else ``MASTER_ADDR`` and ``MASTER_PORT + 17`` (the port's
attach convention, where the JAX package reads
``JAX_COORDINATOR_ADDRESS``). The parser is the JAX launcher's, flag for
flag, plus ``--device`` for ``--serve``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Tuple

from .runtime.config import knob_env

# Remote shells print this after turning pty echo off; the launcher holds the
# job secret until it arrives (see the ssh fan-out below).
_SECRET_READY = "BF_SECRET_READY"


def _send_secret_when_ready(p: "subprocess.Popen", secret: str,
                            host: str) -> None:
    """Write the job secret to ssh stdin only after the remote's
    ``stty -echo`` has run, then pump the rest of its output through.

    The pty allocated by ``ssh -tt`` starts with ECHO on; a secret written
    at Popen time races the remote ``stty -echo`` and can be echoed into
    this process's output. The remote prints ``BF_SECRET_READY`` *after*
    echo is off, so waiting for that marker closes the race.
    """
    buf = b""
    marker = _SECRET_READY.encode()
    try:
        while marker not in buf:
            chunk = p.stdout.read(1)
            if not chunk:  # ssh died before the marker — nothing to send
                sys.stdout.buffer.write(buf)
                sys.stdout.buffer.flush()
                return
            buf += chunk
        p.stdin.write((secret + "\n").encode())
        p.stdin.flush()
        # forward everything after the marker line to our stdout; if OUR
        # stdout goes away (e.g. `bfrun ... | head`), keep DRAINING the ssh
        # pipe — stopping would fill it and wedge the remote job
        sink_broken = False

        def forward(chunk: bytes) -> None:
            nonlocal sink_broken
            if sink_broken:
                return
            try:
                sys.stdout.buffer.write(chunk)
                sys.stdout.buffer.flush()
            except (OSError, ValueError):
                sink_broken = True

        rest = buf.split(marker, 1)[1].lstrip(b"\r\n")
        if rest:
            forward(rest)
        for chunk in iter(lambda: p.stdout.read(4096), b""):
            forward(chunk)
    except (OSError, ValueError):
        pass  # ssh pipe broke at teardown — the exit-code path reports it


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bfrun",
        description="Launch a bluefog_tpu_torch program, or attach to a "
                    "running job (--status, --top, --dump, --serve).",
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


def parse_hosts(hosts: str = None,
                hostfile: str = None) -> List[Tuple[str, int]]:
    """[(host, slots)] from -H 'h1:2,h2:2' or a hostfile.

    Hostfile lines accept the reference's 'host slots=N' (run.py:96-196),
    plus 'host:N' and bare 'host' (slots=1); '#' comments and blanks skipped.
    """
    entries: List[Tuple[str, int]] = []
    if hosts:
        for item in hosts.split(","):
            item = item.strip()
            if not item:
                continue
            host, _, slots = item.partition(":")
            entries.append((host, int(slots) if slots else 1))
    elif hostfile:
        with open(hostfile) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                host = parts[0]
                slots = 1
                for tok in parts[1:]:
                    if tok.startswith("slots="):
                        slots = int(tok[len("slots="):])
                if ":" in host:
                    host, _, s = host.partition(":")
                    slots = int(s)
                entries.append((host, slots))
    for host, slots in entries:
        if slots < 1:
            raise ValueError(f"host {host}: slots must be >= 1, got {slots}")
    return entries


_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}


def _is_local(host: str) -> bool:
    return host in _LOCAL_NAMES or host in (
        socket.gethostname(), socket.getfqdn())


def _check_ssh(host: str, port: int) -> bool:
    """The reference's pre-launch ssh reachability probe (run.py:205-226)."""
    r = subprocess.run(
        ["ssh", "-o", "BatchMode=yes", "-o", "ConnectTimeout=5",
         "-p", str(port), host, "true"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return r.returncode == 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _port_free(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("", port))
        except OSError:
            return False
    return True


def _hold_port(port: int) -> Optional[socket.socket]:
    """A socket bound to ``port`` with ``SO_REUSEADDR`` that never listens,
    or None when another socket holds the port. While it is open the kernel
    gives the port to no other process (neither to a ``bind`` to port 0 nor
    to a plain ``bind``), and the job's own listeners, torch's store and the
    control-plane server, which set ``SO_REUSEADDR`` too, still bind it."""
    if not _port_free(port):
        return None
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("", port))
    except OSError:
        s.close()
        return None
    return s


# the ports this launcher picked for its job, held until the job ends
_held_ports: List[socket.socket] = []


def _release_ports() -> None:
    while _held_ports:
        _held_ports.pop().close()


def _free_master_port(cp_ports: int = 1) -> int:
    """A free ``MASTER_PORT`` whose control-plane ports (``MASTER_PORT +
    17`` and the ``cp_ports - 1`` above it, where rank 0 serves) are free
    too, so the job's rendezvous and its control plane cannot collide.
    The ports stay held (:func:`_hold_port`) until :func:`_release_ports`:
    rank 0 binds them seconds later, after its imports, and a port only
    probed free could meanwhile go to another process's server."""
    from .runtime.control_plane import PORT_OFFSET

    for _ in range(64):
        port = _free_port()
        if port + PORT_OFFSET + cp_ports - 1 > 65535:
            continue
        cp = range(port + PORT_OFFSET, port + PORT_OFFSET + cp_ports)
        held = [_hold_port(p) for p in (port, *cp)]
        if all(held):
            _held_ports.extend(held)
            return port
        for h in held:
            if h is not None:
                h.close()
    raise RuntimeError("no free port P with P + 17 free as well")


# env the fan-out forwards to remote processes (local children inherit all):
# the port's knobs and the framework's own (torch, NCCL), as the JAX
# launcher forwards BLUEFOG_/JAX_/XLA_
_FORWARD_ENV_PREFIXES = ("BFT_", "TORCH_", "NCCL_")


def _supervise_elastic(procs, spawn, base_inc: int, budget: int,
                       min_world: int) -> List[int]:
    """Elastic child supervision (`bfrun --elastic`).

    A crashed rank is respawned in place with ``BFT_INCARNATION`` bumped —
    the control plane then fences the crash's zombie connections and the
    rank rejoins through quarantined state transfer. Respawns back off
    exponentially (0.5 s doubling, capped at 10 s) and are bounded by
    ``budget`` per rank. A terminal failure propagates only when a rank's
    budget is exhausted (its code lands in the returned list; the job
    keeps running for the survivors) or the surviving world would drop
    below ``min_world`` (the whole job is torn down). Returns per-rank
    terminal exit codes (None for ranks still running at a min-world
    teardown — the caller's cleanup terminates and aggregates them).
    """
    total = len(procs)
    restarts = [0] * total
    incs = [base_inc] * total
    final: List = [None] * total     # terminal exit code per rank
    respawn_at = [0.0] * total       # backoff deadline for pending respawns
    pending = set()
    while True:
        now = time.time()
        for i in range(total):
            if final[i] is not None:
                continue
            if i in pending:
                if now >= respawn_at[i]:
                    pending.discard(i)
                    incs[i] += 1
                    procs[i] = spawn(i, incs[i])
                continue
            c = procs[i].poll()
            if c is None:
                continue
            if c == 0:
                final[i] = 0
            elif restarts[i] < budget:
                restarts[i] += 1
                delay = min(0.5 * (2 ** (restarts[i] - 1)), 10.0)
                print(
                    f"bfrun: rank {i} exited with {c}; respawning as "
                    f"incarnation {incs[i] + 1} in {delay:.1f}s "
                    f"(restart {restarts[i]}/{budget})", file=sys.stderr)
                respawn_at[i] = now + delay
                pending.add(i)
            else:
                final[i] = c
                print(
                    f"bfrun: rank {i} exited with {c} and exhausted its "
                    f"restart budget ({budget}); marking it failed",
                    file=sys.stderr)
        failed = sum(1 for c in final if c not in (None, 0))
        if failed and total - failed < min_world:
            print(
                f"bfrun: surviving world {total - failed} dropped below "
                f"--min-world {min_world}; terminating the job",
                file=sys.stderr)
            return [c for c in final if c is not None]
        if all(c is not None for c in final):
            return final
        time.sleep(0.1)


def _spawn_shard_servers(n: int, total: int, advertise_host: str):
    """Launch N control-plane shard server processes on the launching host
    (``bfrun --cp-shards N``); returns (procs, BFT_CP_HOSTS value).
    Blocks until every shard prints its READY line so children can never
    race a bind; server processes inherit the freshly minted job secret
    through the environment.

    With ``BFT_CP_REPLICATION`` (default on) and N > 1 the spawn is
    two-phase: every shard reports its bound port first, the full ring is
    written back over stdin, and each shard wires WAL replication to its
    ring successor before declaring READY — an acked control-plane write
    then survives any single shard's SIGKILL."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "runtime", "shard_server.py")
    replicate = n > 1 and bool(int(knob_env("BFT_CP_REPLICATION")))
    procs = []

    def _fail(i, why):
        for q in procs:
            q.terminate()
        raise RuntimeError(f"control-plane shard {i} failed to start: {why}")

    for i in range(n):
        cmd = [sys.executable, script, "--port", "0", "--world", str(total),
               "--shard", str(i)]
        if replicate:
            cmd.append("--expect-peers")
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stdin=subprocess.PIPE if replicate else None, text=True))
    ports = []
    marker = "BF_SHARD_PORT" if replicate else "BF_SHARD_READY"
    for i, p in enumerate(procs):
        line = p.stdout.readline()
        if not line.startswith(marker):
            _fail(i, repr(line))
        ports.append(int(line.split()[1]))
    if replicate:
        ring = ",".join(f"127.0.0.1:{port}" for port in ports)
        for i, p in enumerate(procs):
            p.stdin.write(f"BF_SHARD_PEERS {ring}\n")
            p.stdin.flush()
        for i, p in enumerate(procs):
            line = p.stdout.readline()
            if not line.startswith("BF_SHARD_READY"):
                _fail(i, repr(line))
    eps = [f"{advertise_host}:{port}" for port in ports]
    return procs, ",".join(eps)


def _stop_shard_servers(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=5)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _mint_secret(env) -> None:
    """One shared secret per job, minted by the launcher into ``env`` and
    handed to every process through the environment (remote ones over ssh
    stdin): the control-plane server then rejects any connection that
    cannot complete the HMAC handshake (reference: HMAC-signed launcher/task
    messages, run/horovodrun/common/util/network.py:69-86)."""
    if "BFT_CP_SECRET" not in env:
        import secrets as _secrets

        env["BFT_CP_SECRET"] = _secrets.token_hex(16)


def _base_incarnation() -> int:
    return max(0, int(knob_env("BFT_INCARNATION")))


def _run_job(total: int, spawn, args, base_inc: int) -> int:
    """Start ``total`` processes with ``spawn(i, incarnation)``, wait for
    them (elastically under ``--elastic``, else the first failure kills the
    job: mpirun's semantics) and return the job's exit code, shell-style
    (a signal death N is 128 + N). Ctrl-C, or SIGTERM to this launcher,
    interrupts every process and returns 130."""
    import signal

    def _interrupted(signum, frame):
        raise KeyboardInterrupt

    old = signal.signal(signal.SIGTERM, _interrupted)
    procs: List[subprocess.Popen] = []
    try:
        try:
            for i in range(total):
                procs.append(spawn(i, base_inc))
            if args.elastic is not None:
                own_exit = _supervise_elastic(
                    procs, spawn, base_inc, max(0, args.elastic),
                    max(1, args.min_world))
            else:
                while True:
                    codes = [p.poll() for p in procs]
                    failed = [c for c in codes if c not in (None, 0)]
                    if failed or all(c is not None for c in codes):
                        break
                    time.sleep(0.1)
                # codes at loop exit are authoritative: processes still
                # running get terminated below, and their -SIGTERM must
                # not mask the real failure
                own_exit = [c for c in codes if c is not None]
        except KeyboardInterrupt:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGINT)
            deadline = time.time() + 5
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            return 130
        for p in procs:
            if p.poll() is None:
                p.terminate()
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for c in own_exit:
            if c != 0:
                return c if c > 0 else 128 + abs(c)
        return 0
    finally:
        signal.signal(signal.SIGTERM, old)


def _fanout(args) -> int:
    """Drive the whole job from this one shell: launch every process, stream
    its output, aggregate exit codes, kill-all on Ctrl-C or first failure."""
    entries = parse_hosts(args.hosts, args.hostfile)
    if not entries:
        print("bfrun: empty host list", file=sys.stderr)
        return 1
    total = sum(s for _, s in entries)
    if args.num_proc is not None and args.num_proc != total:
        print(f"bfrun: -np {args.num_proc} does not match the {total} slots "
              f"in the host list", file=sys.stderr)
        return 1

    remote_hosts = sorted({h for h, _ in entries if not _is_local(h)})
    if remote_hosts:
        # concurrent probes: a slow/down host costs one timeout, not one per
        # host (the reference launcher also probes in parallel)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(32, len(remote_hosts))) as ex:
            ok = list(ex.map(lambda h: _check_ssh(h, args.ssh_port),
                             remote_hosts))
        unreachable = [h for h, good in zip(remote_hosts, ok) if not good]
        if unreachable:
            print(f"bfrun: ssh unreachable host(s): {', '.join(unreachable)}",
                  file=sys.stderr)
            return 1

    _mint_secret(os.environ)

    coordinator = args.coordinator
    if coordinator is None:
        first = entries[0][0]
        if _is_local(first):
            # remote children must be able to route to process 0: advertise
            # a real hostname, loopback only for all-local jobs
            chost = socket.getfqdn() if remote_hosts else "127.0.0.1"
        else:
            chost = first
        # the port is probed free on THIS machine; when process 0 runs
        # remotely that is only a likely-free ephemeral pick — pass an
        # explicit --coordinator if the bind fails there
        coordinator = f"{chost}:{_free_master_port()}"

    # Sharded control plane: the fan-out owns N real shard server processes
    # and every child (local and remote — BFT_* env is forwarded) routes
    # over them instead of rank 0 serving in-process.
    shard_procs: List[subprocess.Popen] = []
    if args.cp_shards and args.cp_shards > 1:
        shost = socket.getfqdn() if remote_hosts else "127.0.0.1"
        try:
            shard_procs, cp_hosts = _spawn_shard_servers(
                args.cp_shards, total, shost)
        except (RuntimeError, OSError, ValueError) as exc:
            print(f"bfrun: {exc}", file=sys.stderr)
            return 1
        os.environ["BFT_CP_HOSTS"] = cp_hosts
        os.environ["BFT_CP_SERVE"] = "0"
        print(f"bfrun: control plane sharded over {args.cp_shards} "
              f"server(s): {cp_hosts}", file=sys.stderr)

    def child_args(pid: int) -> List[str]:
        out = ["-m", "bluefog_tpu_torch.launcher", "-np", str(total),
               "--coordinator", coordinator, "--process-id", str(pid)]
        if args.simulate:
            out += ["--simulate", str(args.simulate)]
        if args.timeline_filename:
            out += ["--timeline-filename", args.timeline_filename]
        if args.verbose:
            out += ["--verbose"]
        if args.chaos:
            out += ["--chaos", args.chaos]
        return out + ["--"] + args.command

    # slot index -> host, and its place among the host's slots (stable
    # across respawns in elastic mode): torchrun's LOCAL_RANK and
    # LOCAL_WORLD_SIZE
    slot_host = [h for h, s in entries for _ in range(s)]
    host_slots = {h: slot_host.count(h) for h in slot_host}
    slot_local = [slot_host[:i].count(h) for i, h in enumerate(slot_host)]
    base_inc = _base_incarnation()

    def spawn(pid: int, inc: int) -> subprocess.Popen:
        host = slot_host[pid]
        local = {"LOCAL_RANK": str(slot_local[pid]),
                 "LOCAL_WORLD_SIZE": str(host_slots[host]),
                 "BFT_INCARNATION": str(inc)}
        if _is_local(host):
            return subprocess.Popen([sys.executable] + child_args(pid),
                                    env={**os.environ, **local})
        # NEVER put the job secret on the remote command line —
        # /proc/<pid>/cmdline is world-readable, so any local user on a
        # shared node could read it and pass the HMAC handshake. It
        # travels over ssh stdin instead (echo off: -tt allocates a pty
        # that would otherwise echo the line into captured output).
        exports = " ".join(
            f"{k}={shlex.quote(v)}"
            for k, v in os.environ.items()
            if (k.startswith(_FORWARD_ENV_PREFIXES) or k == "PYTHONPATH")
            and k not in ("BFT_CP_SECRET", *local))
        exports += "".join(f" {k}={v}" for k, v in local.items())
        secret = os.environ.get("BFT_CP_SECRET", "")
        # '&&' so a missing remote workdir fails loudly instead of becoming
        # an opaque ModuleNotFoundError later. The ready marker closes a
        # race: until the remote stty runs, the pty's ECHO flag is still
        # on, so a secret written at Popen time could be echoed back into
        # the launcher's captured output.
        remote = ("stty -echo 2>/dev/null; "
                  f"printf '{_SECRET_READY}\\n'; "
                  "IFS= read -r BFT_CP_SECRET; "
                  "export BFT_CP_SECRET; "
                  f"cd {shlex.quote(os.getcwd())} && "
                  f"env {exports} {args.remote_python} "
                  + shlex.join(child_args(pid)))
        # -tt: a pty ties the remote process to the connection, so kill-all
        # on the ssh client actually kills the job on the host (and
        # forwards Ctrl-C)
        p = subprocess.Popen(
            ["ssh", "-tt", "-o", "BatchMode=yes",
             "-p", str(args.ssh_port), host, remote],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        threading.Thread(
            target=_send_secret_when_ready,
            args=(p, secret, host), daemon=True).start()
        return p

    try:
        return _run_job(total, spawn, args, base_inc)
    finally:
        _stop_shard_servers(shard_procs)
        _release_ports()


def _split_address(address: str) -> Tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not host:
        raise ValueError(f"--coordinator {address!r} is not host:port")
    return host, int(port)


def _simulate(args, env: dict) -> int:
    """``--simulate N``: N ranks of this host as N processes on the CPU
    over gloo (``BFT_SIMULATE_DEVICES=N`` makes ``bf.init`` take the CPU
    even beside a GPU), where the JAX launcher runs one process over N
    forced CPU devices. Under ``-np P --process-id i`` the N processes are
    ranks ``i*N .. i*N+N-1`` of a world of ``P*N``, as JAX's multi-process
    simulate job ranks over every process's devices. The processes share
    this terminal; their exit codes aggregate as the fan-out's do."""
    n = args.simulate
    pid = args.process_id or 0
    world = (args.num_proc or 1) * n
    if args.coordinator:
        host, port = _split_address(args.coordinator)
    else:
        host, port = "127.0.0.1", _free_master_port(
            max(1, args.cp_shards or 1))
    _mint_secret(env)
    env.update(BFT_SIMULATE_DEVICES=str(n), MASTER_ADDR=host,
               MASTER_PORT=str(port), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(n))

    def spawn(j: int, inc: int) -> subprocess.Popen:
        return subprocess.Popen(args.command, env={
            **env, "RANK": str(pid * n + j), "LOCAL_RANK": str(j),
            "BFT_INCARNATION": str(inc)})

    try:
        return _run_job(n, spawn, args, _base_incarnation())
    finally:
        _release_ports()


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
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]

    # fan-out mode: a host list without an explicit --process-id means THIS
    # invocation fans out the whole job (children re-enter below with ids)
    if (args.hosts or args.hostfile) and args.process_id is None:
        return _fanout(args)

    env = dict(os.environ)
    if args.cp_shards and args.cp_shards > 1:
        # exec mode: rank 0's bf.init serves all N shards in-process
        # (the fan-out above launches real server processes instead)
        env["BFT_CP_SHARDS"] = str(args.cp_shards)
    if args.timeline_filename:
        env["BFT_TIMELINE"] = args.timeline_filename
    if args.verbose:
        env["BFT_LOG_LEVEL"] = "debug"
    if args.chaos:
        # validate NOW so a typo'd spec fails the launch, not (silently,
        # as a warning) deep inside every child's native-runtime load
        from .runtime.native import parse_fault_spec
        parse_fault_spec(args.chaos)
        env["BFT_CP_FAULT"] = args.chaos
    if args.num_proc and args.num_proc > 1 and (
            not args.coordinator or args.process_id is None):
        print("bfrun: -np > 1 requires --coordinator and --process-id",
              file=sys.stderr)
        return 1
    if args.simulate:
        return _simulate(args, env)
    if args.num_proc and args.coordinator and args.process_id is not None:
        # torchrun's environment, which bf.init joins through env://
        host, port = _split_address(args.coordinator)
        env.update(MASTER_ADDR=host, MASTER_PORT=str(port),
                   WORLD_SIZE=str(args.num_proc), RANK=str(args.process_id))

    cmd = args.command
    os.execvpe(cmd[0], cmd, env)

if __name__ == "__main__":
    sys.exit(main())
