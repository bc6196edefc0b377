"""Snapshot-publisher child of the port's serving tests (SIGKILL bait).

Loops publishing versioned snapshots through the port's
``SnapshotPublisher`` whose every element equals the version, so a torn
read (shards of two versions stitched together) shows as a value mismatch.
``--inter-shard-ms`` sleeps between shard writes, so a SIGKILL lands
between a shard write and the fence move. Prints ``PUB <ver>`` after each
committed version; runs until killed.

    python tests/_torch_port_serve_pub_child.py --port P --start-ver V \\
        [--shards S] [--elems N] [--inter-shard-ms MS]
"""

import argparse
import os
import sys

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
    args = p.parse_args()
    cl = ControlPlaneClient(args.host, args.port, 0, streams=1)
    pub = SnapshotPublisher(cl, shards=args.shards, keep=2)
    pub._inter_shard_sleep = args.inter_shard_ms / 1e3
    ver = args.start_ver
    while True:
        leaves = [np.full(args.elems, float(ver), np.float32),
                  np.full(args.elems // 3 + 1, float(ver), np.float32)]
        pub.publish(leaves, ver, step=ver)
        print(f"PUB {ver}", flush=True)
        ver += 1


if __name__ == "__main__":
    sys.exit(main())
