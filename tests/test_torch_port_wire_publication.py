"""Port vs JAX: metrics publication, cluster health and the remote dump
trigger over the control plane, in a world of 4 gloo processes.

The test process serves the control plane (the port's server, world 4)
and four ranks of ``tests/_torch_port_child.py`` (mode ``wire``) attach to
it through ``bf.init`` with ``BFT_CP_HOST``/``BFT_CP_PORT``,
``BFT_CP_SERVE=0`` and ``BFT_INCARNATION=2``. Each rank takes 3 optimizer
steps and publishes, then:

* every rank's ``cluster_health()`` shows all four ranks at step 3 with
  incarnation 2, none missing;
* one bump of ``bf.flight.trigger`` by rank 0 fires exactly one dump on
  each rank (the second poll returns False): four files under
  ``BFT_FLIGHT_DIR``, four KV tails ``bf.flight.<r>`` that decode, four
  acks;
* the log prefix reads ``[rank r / inc 2] ``;
* ``BFT_METRICS_PROM`` leaves four per-rank files, each holding only its
  own rank's ``rank="r"`` samples (one file at world 1, as before).

From outside the job a raw port client's ``read_cluster_health`` equals
the JAX package's ``read_cluster_health`` over the same KV through a JAX
client (staleness aside, which each reads off its own clock), and every
rank's BFM1 blob decodes with JAX's ``unpack_snapshot`` as with the
port's.
"""

import json
import re

import numpy as np

from bluefog_tpu.runtime import metrics as jmetrics
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu_torch.runtime import flight, metrics, native

from _torch_port_child import run_world

WORLD = 4


def _strip_staleness(health: dict) -> dict:
    health = json.loads(json.dumps(health))
    for r in health["ranks"].values():
        r.pop("staleness_sec")
    return health


def test_world4_publication_health_and_trigger(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    np.savez(tmp_path / "inputs.npz",
             x=rng.standard_normal((WORLD, 2, 3)).astype(np.float32))
    srv = native.ControlPlaneServer(WORLD, 0)
    try:
        for k, v in {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
                     "BFT_CP_SERVE": "0", "BFT_INCARNATION": "2",
                     "BFT_CP_CONNECT_TIMEOUT": "60",
                     "BFT_METRICS_INTERVAL": "0.2",
                     "BFT_METRICS_PROM": str(tmp_path / "scrape.prom"),
                     "BFT_FLIGHT_DIR": str(tmp_path),
                     # the heartbeat's tick polls the dump trigger too;
                     # its first tick comes after the job ends, so the
                     # two explicit polls are the only ones
                     "BFT_HEARTBEAT_INTERVAL": "600"}.items():
            monkeypatch.setenv(k, v)
        outs = run_world("wire", str(tmp_path), WORLD, timeout=240)

        for r, out in enumerate(outs):
            assert out["active"] and int(out["cp_world"]) == WORLD
            assert out["health_steps"].tolist() == [3] * WORLD, r
            assert out["health_inc"].tolist() == [2] * WORLD, r
            assert int(out["missing"]) == 0
            assert out["fired"].tolist() == [True, False], r
            assert str(out["log_prefix"]) == f"[rank {r} / inc 2] "

        # from outside the job: the port's and the JAX package's readings
        p = native.ControlPlaneClient("127.0.0.1", srv.port, 100, streams=1)
        j = jnative.ControlPlaneClient("127.0.0.1", srv.port, 101,
                                       streams=1)
        ph = metrics.read_cluster_health(p)
        jh = jmetrics.read_cluster_health(j)
        assert _strip_staleness(ph) == _strip_staleness(jh)
        assert ph["world"] == WORLD and ph["missing"] == []
        assert [ph["ranks"][r]["step"] for r in range(WORLD)] == [3] * WORLD
        for r in range(WORLD):
            blob = p.get_bytes(f"bf.metrics.{r}")
            assert blob == j.get_bytes(f"bf.metrics.{r}")
            snap = jmetrics.unpack_snapshot(blob)
            assert snap == metrics.unpack_snapshot(blob)
            assert snap["meta"]["rank"] == r and snap["meta"]["inc"] == 2
            assert snap["gauges"]["opt.step"] == 3.0
            # the remote dump: the file, its KV tail and the ack
            tail = flight.unpack_dump(p.get_bytes(f"bf.flight.{r}"))
            assert tail["meta"]["reason"] == "remote-trigger #1"
            assert tail["meta"]["rank"] == r and tail["meta"]["inc"] == 2
            with open(tmp_path / f"bf_flight_{r}.json") as f:
                assert json.load(f)["meta"]["reason"] == "remote-trigger #1"
            assert p.get(f"bf.flight.ack.{r}") == 1
        assert p.get("bf.flight.trigger") == 1
        p.close()
        j.close()
    finally:
        srv.stop()

    # one Prometheus file per rank, each with its own rank's samples only
    assert not (tmp_path / "scrape.prom").exists()
    for r in range(WORLD):
        text = (tmp_path / f"scrape.{r}.prom").read_text()
        ranks = set(re.findall(r'rank="(\d+)"', text))
        assert ranks == {str(r)}, (r, ranks)
        assert f'bluefog_opt_step{{rank="{r}"}} 3' in text


def test_prometheus_path_per_rank(monkeypatch):
    """``BFT_METRICS_PROM`` is the file itself in a world of one; in a
    larger world each rank writes ``<root>.<rank><ext>`` of it, so the
    ranks of one host do not replace each other's file."""
    monkeypatch.setenv("BFT_METRICS_PROM", "/srv/scrape.prom")
    assert metrics.prom_path(0, 1) == "/srv/scrape.prom"
    assert metrics.prom_path(3, 4) == "/srv/scrape.3.prom"
    monkeypatch.setenv("BFT_METRICS_PROM", "/srv/metrics")
    assert metrics.prom_path(1, 2) == "/srv/metrics.1"
    monkeypatch.delenv("BFT_METRICS_PROM")
    assert metrics.prom_path(1, 2) is None
