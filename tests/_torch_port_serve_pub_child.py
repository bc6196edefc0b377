"""Snapshot-publisher child of the port's serving tests (SIGKILL bait).

Loops publishing versioned snapshots through the port's
``SnapshotPublisher`` whose every element equals the version, so a torn
read (shards of two versions stitched together) shows as a value mismatch.
``--inter-shard-ms`` sleeps between shard writes, so a SIGKILL lands
between a shard write and the fence move. Prints ``PUB <ver>`` after each
committed version; runs until killed.

    python tests/_torch_port_serve_pub_child.py --port P --start-ver V \\
        [--shards S] [--elems N] [--inter-shard-ms MS] [--keep K] \\
        [--period-ms MS] [--flight-dump PATH --flight-rank R]

``--period-ms`` paces the publishes (default: a tight loop).
``--flight-dump`` makes SIGTERM a clean exit that first writes this
process's flight ring (the publish spans and shard flows when
``BFT_TRACE_SERVE=1``) to PATH with ``meta.rank`` set to
``--flight-rank``, for a parent to merge with its own.
"""

import argparse
import json
import os
import signal
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from bluefog_tpu_torch.runtime.native import ControlPlaneClient  # noqa: E402
from bluefog_tpu_torch.serving.snapshot import SnapshotPublisher  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--start-ver", type=int, default=1)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--elems", type=int, default=5000)
    p.add_argument("--inter-shard-ms", type=float, default=0.0)
    p.add_argument("--keep", type=int, default=2)
    p.add_argument("--period-ms", type=float, default=0.0)
    p.add_argument("--flight-dump", default=None)
    p.add_argument("--flight-rank", type=int, default=1)
    args = p.parse_args()
    stop = threading.Event()
    if args.flight_dump:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    cl = ControlPlaneClient(args.host, args.port, 0, streams=1)
    pub = SnapshotPublisher(cl, shards=args.shards, keep=args.keep)
    pub._inter_shard_sleep = args.inter_shard_ms / 1e3
    ver = args.start_ver
    while not stop.is_set():
        leaves = [np.full(args.elems, float(ver), np.float32),
                  np.full(args.elems // 3 + 1, float(ver), np.float32)]
        pub.publish(leaves, ver, step=ver)
        print(f"PUB {ver}", flush=True)
        ver += 1
        if args.period_ms > 0:
            stop.wait(args.period_ms / 1e3)
    if args.flight_dump:
        from bluefog_tpu_torch.runtime import flight
        doc = flight.build_dump("pub-exit")
        doc["meta"]["rank"] = args.flight_rank
        with open(args.flight_dump, "w") as f:
            json.dump(doc, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
