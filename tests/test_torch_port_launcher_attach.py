"""Port vs JAX: ``bfrun``'s attach modes (``--status``, ``--top``,
``--dump``, ``--serve``).

``bluefog_tpu_torch/launcher.py`` against ``bluefog_tpu/launcher.py``:

* ``build_parser``: the same flags, dests and defaults; the port adds
  ``--device`` (for ``--serve``) only;
* ``_strict_findings`` (``tests/test_flight.py:557-600``),
  ``_shard_drift_findings`` and ``_slo_budget_findings`` give the same
  findings on the same inputs;
* over one live world-4 port job (gloo children of
  ``tests/_torch_port_serve_child.py``, mode ``attach_job``, under a
  control plane this process serves, each rank published once):
  ``_status`` and ``_status --strict`` print JAX's text line for line and
  exit alike, ``_top --once`` renders JAX's frame line for line (with a
  fifth, silent rank too; ``tests/test_metrics.py:267``,
  ``tests/test_timeseries.py:450``), apart from the time fields (the
  publication ages and the frame's clock); ``--dump`` from a subprocess
  retrieves every rank's ring (``tests/test_flight.py:533``) and
  ``--serve --once --device cpu`` from a subprocess mirrors the job's
  snapshot and exits 0;
* ``--serve --once`` exits 1 on a control plane with no snapshot, the
  address falls back to ``MASTER_ADDR`` and ``MASTER_PORT + 17``, and a
  command line that asks to launch a program launches it (the launch modes
  themselves: ``tests/test_torch_port_launcher_launch.py``).
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from bluefog_tpu import launcher as jlauncher
from bluefog_tpu.runtime import native as jnative
from bluefog_tpu_torch import launcher
from bluefog_tpu_torch.runtime import native
from bluefog_tpu_torch.runtime import timeseries as ts
from bluefog_tpu_torch.serving import snapshot as snap

from _torch_port_serve_child import collect, spawn

REPO = Path(__file__).resolve().parent.parent
WORLD = 4


def _actions(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const)
            for a in parser._actions}


def test_build_parser_matches_jax():
    port, jax_ = _actions(launcher.build_parser()), \
        _actions(jlauncher.build_parser())
    assert set(port) - set(jax_) == {"device"}
    assert port["device"] == (("--device",), "cuda", None, None)
    for dest, spec in jax_.items():
        assert port[dest] == spec, dest
    argv = ["--top", "--once", "--interval", "0.5", "--world", "4"]
    pa, ja = (m.build_parser().parse_args(argv)
              for m in (launcher, jlauncher))
    assert {k: v for k, v in vars(pa).items() if k != "device"} == vars(ja)


_HEALTH = {
    "healthy": {"ranks": {0: {"alive": True}}, "stragglers": [],
                "mass": {"conserved": True, "drift": 0.0,
                         "tolerance": 1e-12}},
    "sick": {"ranks": {0: {"alive": True}, 1: {"alive": False}},
             "stragglers": [2],
             "mass": {"conserved": False, "drift": -0.5,
                      "tolerance": 1e-12}},
    "no_mass": {"ranks": {}, "stragglers": [], "mass": None},
    "repl_none": {"ranks": {}, "stragglers": [], "mass": None,
                  "repl": None},
    "repl_ok": {"ranks": {}, "stragglers": [], "mass": None,
                "repl": {"lag": 10.0, "under_replicated": 0}},
    "repl_under": {"ranks": {}, "stragglers": [], "mass": None,
                   "repl": {"lag": 10.0, "under_replicated": 2}},
}


@pytest.mark.parametrize("case", list(_HEALTH))
def test_strict_findings_match_jax(case):
    health = _HEALTH[case]
    got = launcher._strict_findings(health)
    assert got == jlauncher._strict_findings(health)
    assert len(got) == {"sick": 3, "repl_under": 1}.get(case, 0)


def test_drift_and_slo_budget_findings_match_jax(monkeypatch):
    """A sustained shard-rotation drift stream for rank 0
    (``tests/test_timeseries.py:499``) and a serve client whose error
    budget is spent: the same findings in both packages."""
    for pre in ("BFT_", "BLUEFOG_"):
        monkeypatch.setenv(pre + "SLO", "serve_p99:50ms@10s")
    with native.ControlPlaneServer(world=1) as srv:
        cl = native.ControlPlaneClient("127.0.0.1", srv.port, 0)
        jcl = jnative.ControlPlaneClient("127.0.0.1", srv.port, 1)
        now = time.time()
        store = ts.TimeSeriesStore()
        s = store.series("win.shard_stale_drops.rate", "gauge", "mean")
        for i in range(5):
            s.add(now - 5 + i, 2.0)
        cl.put_bytes(ts.TS_KEY_FMT.format(rank=0), ts.pack_doc(
            store.build_doc(0, 0, now, 1.0)))
        cid = snap.claim_client_slot(cl)
        slo = ts.TimeSeriesStore()
        req = slo.series("slo.requests", "counter", "last")
        err = slo.series("slo.breach.serve_p99", "counter", "last")
        for i in range(30):
            req.add(now - 30 + i, 10.0 * i)
            err.add(now - 30 + i, 10.0 * i)
        slo._evaluate_slos(now - 1)
        rank = ts.SERVE_TS_RANK_BASE + cid
        cl.put_bytes(ts.TS_KEY_FMT.format(rank=rank), ts.pack_doc(
            slo.build_doc(rank, 0, now, 1.0)))
        drift = launcher._shard_drift_findings(cl, 1)
        assert drift == jlauncher._shard_drift_findings(jcl, 1)
        assert len(drift) == 1 and "shard-rotation drift" in drift[0]
        budget = launcher._slo_budget_findings(cl)
        assert budget == jlauncher._slo_budget_findings(jcl)
        assert len(budget) == 1 and "exhausted" in budget[0]
        cl.close()
        jcl.close()


# ---------------------------------------------------------------------------
# one live world-4 port job
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A world-4 port job under a control plane this process serves: each
    rank trained 3 push-sum steps (controller 0 publishing a snapshot each
    step), published its metrics and time series once, and waits for
    ``test.done``."""
    tmp = tmp_path_factory.mktemp("torch_port_attach_job")
    rng = np.random.default_rng(9)
    np.savez(tmp / "inputs.npz",
             x=rng.standard_normal((WORLD, 5, 6)).astype(np.float32))
    srv = native.ControlPlaneServer(WORLD, 0)
    env = {"BFT_CP_HOST": "127.0.0.1", "BFT_CP_PORT": str(srv.port),
           "BFT_CP_SERVE": "0", "BFT_CP_CONNECT_TIMEOUT": "60",
           "BFT_SERVE_PUBLISH_EVERY": "1", "BFT_SERVE_SHARDS": "2",
           "BFT_FLIGHT_DIR": str(tmp), "BFT_HEARTBEAT_INTERVAL": "0.5",
           "BFT_TS_INTERVAL": "600"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    procs = spawn("attach_job", str(tmp), WORLD)
    cl = native.ControlPlaneClient("127.0.0.1", srv.port, 100, streams=1)
    try:
        deadline = time.monotonic() + 180
        while cl.get("test.ready") < WORLD:
            assert time.monotonic() < deadline, "the job never got ready"
            assert all(p.poll() is None for p in procs), "a rank died"
            time.sleep(0.05)
        yield types.SimpleNamespace(port=srv.port, tmp=tmp, cl=cl)
        cl.put("test.done", 1)
        collect(procs, str(tmp))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        cl.close()
        srv.stop()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _mask(text: str) -> str:
    """The reader-clock fields blanked: publication ages and clock time."""
    text = re.sub(r"published \d+\.\d+ ?s ago", "published <age>", text)
    return re.sub(r"\b\d\d:\d\d:\d\d\b", "<hh:mm:ss>", text)


def _run(fn, args) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(args)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("strict", [False, True])
def test_status_text_matches_jax(job, strict):
    """The same text and exit in both packages. The job's ranks stopped
    after their third step with that step's deposits still in their peers'
    mailboxes, so the live ranks' p sums to less than they minted: the
    view says DRIFTING and ``--strict`` exits 2 on that finding alone."""
    args = types.SimpleNamespace(cp=f"127.0.0.1:{job.port}", status=True,
                                 strict=strict)
    p_rc, p_out, p_err = _run(launcher._status, args)
    j_rc, j_out, j_err = _run(jlauncher._status, args)
    assert p_rc == j_rc == (2 if strict else 0), p_err + j_err
    assert _mask(p_out).splitlines() == _mask(j_out).splitlines()
    assert _mask(p_err) == _mask(j_err)
    assert "cluster health — world 4" in p_out
    for r in range(WORLD):
        assert f"  rank {r}: step 3," in p_out
    assert "push-sum mass: total" in p_out
    assert re.search(r"snapshot v3 \(step 3\), published", p_out)
    if strict:
        assert p_err.count("STRICT:") == 1 and "mass drift" in p_err


@pytest.mark.parametrize("world", [0, WORLD + 1])
def test_top_once_frame_matches_jax(job, world):
    args = types.SimpleNamespace(cp=f"127.0.0.1:{job.port}", top=True,
                                 once=True, world=world, interval=2.0)
    p_rc, p_out, _ = _run(launcher._top, args)
    j_rc, j_out, _ = _run(jlauncher._top, args)
    assert p_rc == j_rc == 0
    assert _mask(p_out).splitlines() == _mask(j_out).splitlines()
    n = world or WORLD
    assert f"{n} rank(s)" in p_out
    for r in range(WORLD):
        assert f"\n  {r:>4} " in p_out, f"rank {r} missing:\n{p_out}"
    if world:
        assert f"SILENT rank(s): [{WORLD}]" in p_out


def _cli(*argv, timeout: float = 120.0) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-m", "bluefog_tpu_torch.launcher",
                           *argv], env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_dump_from_a_subprocess(job):
    out_dir = job.tmp / "remote"
    res = _cli("--dump", "--cp", f"127.0.0.1:{job.port}", "--out",
               str(out_dir), "--dump-timeout", "60")
    assert res.returncode == 0, res.stderr + res.stdout
    for r in range(WORLD):
        doc = json.loads((out_dir / f"flight_{r}.json").read_text())
        assert doc["meta"]["reason"].startswith("remote-trigger")
        assert doc["meta"]["rank"] == r and doc["events"]["kind"]
    merged = json.loads((out_dir / "merged.json").read_text())
    assert any(e.get("name") == "bf.clock_sync_us" for e in merged)
    assert {e["pid"] for e in merged} >= set(range(WORLD))


def test_serve_once_from_a_subprocess(job):
    res = _cli("--serve", "--once", "--device", "cpu", "--cp",
               f"127.0.0.1:{job.port}", "--serve-timeout", "60")
    assert res.returncode == 0, res.stderr + res.stdout
    assert re.search(r"^bfrun --serve: snapshot v3 \(\d+\.\d MB wire total",
                     res.stdout, re.M), res.stdout


def test_serve_once_exits_1_without_a_snapshot(monkeypatch):
    monkeypatch.setenv("BFT_SERVE_POLL_S", "0.05")
    with native.ControlPlaneServer(world=1) as srv:
        rc, _, err = _run(launcher.main, ["--serve", "--once", "--device",
                                          "cpu", "--cp",
                                          f"127.0.0.1:{srv.port}",
                                          "--serve-timeout", "0.5"])
    assert rc == 1
    assert "no complete snapshot within 0.5 s" in err
    assert "BFT_SERVE_PUBLISH_EVERY" in err


def test_cp_address_resolution(monkeypatch, capsys):
    for k in ("BFT_CP_HOSTS", "BFT_CP_HOST", "BFT_CP_PORT", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    args = types.SimpleNamespace(cp=None)
    assert launcher._cp_address(args, "--status") is None
    assert "BFT_CP_HOST/BFT_CP_PORT" in capsys.readouterr().err
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert launcher._cp_address(args, "--status") == [("10.0.0.7", 29517)]
    monkeypatch.setenv("BFT_CP_HOST", "10.0.0.8")
    monkeypatch.setenv("BFT_CP_PORT", "4000")
    assert launcher._cp_address(args, "--status") == [("10.0.0.8", 4000)]
    monkeypatch.setenv("BFT_CP_HOSTS", "h1:1,h2:2")
    assert launcher._cp_address(args, "--status") == [("h1", 1), ("h2", 2)]
    args.cp = "h3:3"
    assert launcher._cp_address(args, "--status") == [("h3", 3)]


@pytest.mark.parametrize("argv,want", [
    (["python", "train.py"], [["python", "train.py"]]),
    (["-np", "2", "--coordinator", "h:1", "--process-id", "0", "python",
      "t"], [["python", "t"]]),
    (["--simulate", "4", "--elastic", "--", "python", "t.py"],
     [["python", "t.py"]] * 4),
])
def test_launching_a_program_launches(argv, want, monkeypatch):
    """A command line that asks to launch a program launches it: exec mode
    (``os.execvpe``), with ``-np`` as rank 0 of 2, or ``--simulate 4``
    under ``--elastic`` as 4 supervised processes (``subprocess.Popen``);
    both monkeypatched to record what would start."""
    started = []

    class Done:
        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    monkeypatch.setattr(os, "execvpe", lambda prog, args, env:
                        started.append((args, env)))
    monkeypatch.setattr(launcher.subprocess, "Popen", lambda cmd, env:
                        started.append((cmd, env)) or Done())
    rc = launcher.main(argv)
    assert [cmd for cmd, _ in started] == want
    if argv[0] == "-np":
        assert [(e["MASTER_ADDR"], e["MASTER_PORT"], e["WORLD_SIZE"],
                 e["RANK"]) for _, e in started] == [("h", "1", "2", "0")]
    if argv[0] == "--simulate":
        assert rc == 0
        assert [e["RANK"] for _, e in started] == ["0", "1", "2", "3"]
    assert launcher.main([]) == 1
