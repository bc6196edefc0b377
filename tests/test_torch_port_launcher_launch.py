"""Port vs JAX: ``bfrun``'s launch modes.

``bluefog_tpu_torch/launcher.py`` against ``bluefog_tpu/launcher.py`` and
the non-slow tests of ``tests/test_launcher.py``:

* exec mode exports the ``BFT_*`` twins of the JAX launcher's
  ``BLUEFOG_*`` variables (``os.execvpe`` monkeypatched in both), checks a
  ``--chaos`` spec before the exec, and ``-np``/``--coordinator``/
  ``--process-id`` become ``torchrun``'s environment;
* ``--simulate N`` starts N processes on the CPU over gloo, each with its
  rank, and ``init`` takes the CPU there;
* ``parse_hosts``, the parser's ``--elastic`` forms, the refusals (``-np``
  without a coordinator, ``-np`` against the host list's slots) and the
  three elastic supervisions give the same results, stderr lines and exit
  codes as the JAX launcher run beside them;
* jobs launched through the port: two processes of ``-np 2`` by hand, four
  through one ``-H localhost:4`` (the four-controller windows, topology
  check and fence of ``tests/_quad_child.py``; then one controller
  crashing, seen by every survivor), and a fan-out over ``--cp-shards``
  shard servers. The children are ``tests/_torch_port_launch_child.py``.

Each subprocess has a timeout of its own. The slow tests are those the JAX
package marks slow, plus the three two-controller runs its slow
``_launch_pair`` makes.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bluefog_tpu import launcher as jlauncher
from bluefog_tpu_torch import launcher

TESTS = Path(__file__).resolve().parent
CHILD = str(TESTS / "_torch_port_launch_child.py")
LAUNCH_TIMEOUT = 90
_SCRUB = ("XLA_FLAGS", "JAX_PLATFORMS", "WORLD_SIZE", "RANK", "LOCAL_RANK",
          "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _env(tmp_path=None, **extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in _SCRUB and not k.startswith(("BFT_", "BLUEFOG_"))}
    repo = str(TESTS.parent)
    env["PYTHONPATH"] = os.pathsep.join([repo, str(TESTS),
                                         env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    if tmp_path is not None:
        env["BFT_FLIGHT_DIR"] = env["BLUEFOG_FLIGHT_DIR"] = str(tmp_path)
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(pkg: str, argv, env, cwd=None):
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.launcher"] + list(argv), env=env,
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _both(argv_jax, argv_port, env, cwd=None, timeout=LAUNCH_TIMEOUT):
    """Run the JAX launcher and the port's side by side; their results."""
    procs = [_run("bluefog_tpu", argv_jax, env, cwd),
             _run("bluefog_tpu_torch", argv_port, env, cwd)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _bfrun_lines(err: str) -> list:
    return sorted(ln for ln in err.splitlines() if ln.startswith("bfrun"))


# ---------------------------------------------------------------------------
# exec mode: the exported environment
# ---------------------------------------------------------------------------

@pytest.fixture
def execs(monkeypatch):
    captured = []
    monkeypatch.setattr(os, "execvpe", lambda prog, args, env:
                        captured.append((prog, args, env)))
    return captured


def test_parser_env_export(execs):
    """--timeline-filename, --verbose, --cp-shards and --chaos export the
    port's twins of the variables the JAX launcher exports."""
    argv = ["--timeline-filename", "/tmp/tl_", "--verbose", "--cp-shards",
            "3", "--chaos", "drop_after=37,delay_ms=50,seed=7", "--",
            "prog", "a1"]
    jlauncher.main(argv)
    launcher.main(argv)
    (jprog, jargs, jenv), (prog, args, env) = execs
    assert (prog, args) == (jprog, jargs) == ("prog", ["prog", "a1"])
    for name in ("TIMELINE", "LOG_LEVEL", "CP_SHARDS", "CP_FAULT"):
        assert env["BFT_" + name] == jenv["BLUEFOG_" + name], name
    assert env["BFT_TIMELINE"] == "/tmp/tl_"
    assert env["BFT_LOG_LEVEL"] == "debug"
    assert env["BFT_CP_SHARDS"] == "3"
    assert not any(k.startswith("BLUEFOG_") and k not in os.environ
                   for k in env)


def test_chaos_spec_checked_before_exec(execs):
    for main in (jlauncher.main, launcher.main):
        with pytest.raises(ValueError):
            main(["--chaos", "no_such_fault=1", "--", "prog"])
    assert execs == []


@pytest.mark.parametrize("argv,want", [
    (["-np", "2", "--coordinator", "h1:1234", "--process-id", "1"],
     {"MASTER_ADDR": "h1", "MASTER_PORT": "1234", "WORLD_SIZE": "2",
      "RANK": "1"}),
    (["-np", "1", "--coordinator", "127.0.0.1:29400", "--process-id", "0"],
     {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29400", "WORLD_SIZE": "1",
      "RANK": "0"}),
])
def test_np_exports_torchrun_env(execs, monkeypatch, argv, want):
    """``-np``/``--coordinator``/``--process-id`` become the variables
    ``bf.init`` joins through ``env://``, where JAX exports its own."""
    for k in want:
        monkeypatch.delenv(k, raising=False)
    launcher.main(argv + ["--", "prog"])
    jlauncher.main(argv + ["--", "prog"])
    (_, _, env), (_, _, jenv) = execs
    assert {k: env[k] for k in want} == want
    if argv[1] != "1":      # JAX exports its own only above one process
        assert (jenv["JAX_COORDINATOR_ADDRESS"], jenv["JAX_NUM_PROCESSES"],
                jenv["JAX_PROCESS_ID"]) == (
                    f"{want['MASTER_ADDR']}:{want['MASTER_PORT']}",
                    want["WORLD_SIZE"], want["RANK"])


def test_simulate_env_export(monkeypatch):
    """``--simulate 4`` starts 4 processes of the command, ranks 0-3 of a
    world of 4 on one loopback rendezvous, with ``BFT_SIMULATE_DEVICES``."""
    started = []

    class Done:
        def poll(self):
            return 0

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, env):
        started.append((cmd, env))
        return Done()

    monkeypatch.setattr(launcher.subprocess, "Popen", fake_popen)
    monkeypatch.delenv("BFT_CP_SECRET", raising=False)
    environ = dict(os.environ)
    assert launcher.main(["--simulate", "4", "--timeline-filename",
                          "/tmp/tl_", "--", "prog", "a1"]) == 0
    assert [cmd for cmd, _ in started] == [["prog", "a1"]] * 4
    envs = [env for _, env in started]
    assert [e["RANK"] for e in envs] == ["0", "1", "2", "3"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2", "3"]
    for e in envs:
        assert (e["WORLD_SIZE"], e["LOCAL_WORLD_SIZE"],
                e["BFT_SIMULATE_DEVICES"], e["MASTER_ADDR"],
                e["BFT_TIMELINE"], e["BFT_INCARNATION"]) == (
                    "4", "4", "4", "127.0.0.1", "/tmp/tl_", "0")
        assert e["MASTER_PORT"] == envs[0]["MASTER_PORT"]
        assert e["BFT_CP_SECRET"] == envs[0]["BFT_CP_SECRET"]
    assert len(envs[0]["BFT_CP_SECRET"]) == 32
    assert dict(os.environ) == environ      # minted into the ranks' only


def test_multiproc_requires_coordinator(capsys):
    for main in (jlauncher.main, launcher.main):
        assert main(["-np", "2", "--", "prog"]) == 1
        assert main([]) == 1
    err = capsys.readouterr().err
    assert err.count("bfrun: -np > 1 requires --coordinator and "
                     "--process-id") == 2


def test_parse_hosts_formats(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\nh1 slots=4\nh2:2\nh3\n\n")
    for hosts in ("h1:2,h2:2", "h1, h2:3", ",h1,"):
        assert launcher.parse_hosts(hosts) == jlauncher.parse_hosts(hosts)
    assert launcher.parse_hosts(hostfile=str(hf)) == \
        jlauncher.parse_hosts(hostfile=str(hf)) == \
        [("h1", 4), ("h2", 2), ("h3", 1)]
    for parse in (launcher.parse_hosts, jlauncher.parse_hosts):
        with pytest.raises(ValueError):
            parse("h1:0")


def test_fanout_rejects_np_slot_mismatch():
    argv = ["-np", "3", "-H", "localhost:2", "--", "true"]
    (jrc, _, jerr), (rc, _, err) = _both(argv, argv, _env(), timeout=60)
    assert rc == jrc == 1
    assert "does not match" in err
    assert _bfrun_lines(err) == _bfrun_lines(jerr)


def test_fanout_reports_unreachable_hosts(monkeypatch, capsys):
    """A host that fails the ssh probe stops the fan-out before anything
    starts, with JAX's line (the probe monkeypatched in both)."""
    for mod in (jlauncher, launcher):
        monkeypatch.setattr(mod, "_check_ssh", lambda host, port: host != "h2")
        monkeypatch.setattr(mod.subprocess, "Popen", None)
    argv = ["-H", "h1:1,h2:2,localhost:1", "--", "prog"]
    assert jlauncher.main(argv) == launcher.main(argv) == 1
    err = capsys.readouterr().err.splitlines()
    assert err == ["bfrun: ssh unreachable host(s): h2"] * 2


def test_elastic_parser_forms():
    for build in (launcher.build_parser, jlauncher.build_parser):
        p = build()
        a = p.parse_args(["--elastic", "--", "prog"])
        assert a.elastic == 3  # bare flag: default budget
        a = p.parse_args(["--elastic=5", "--min-world", "2", "--", "prog"])
        assert a.elastic == 5 and a.min_world == 2
        a = p.parse_args(["--", "prog"])
        assert a.elastic is None


# ---------------------------------------------------------------------------
# elastic supervision, against the JAX launcher run beside it
# ---------------------------------------------------------------------------

_RANK = ("(os.environ.get('RANK') or os.environ.get('JAX_PROCESS_ID'))")
_INC = ("int(os.environ.get('BFT_INCARNATION') or "
        "os.environ.get('BLUEFOG_INCARNATION') or 0)")


def test_elastic_respawns_with_bumped_incarnation(tmp_path):
    """A rank that crashes is respawned with its incarnation raised by one;
    the job succeeds once the respawn does."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import os, sys\n"
        f"inc = {_INC}\n"
        f"print(f'probe pid={{{_RANK}}} inc={{inc}}', flush=True)\n"
        "sys.exit(0 if inc >= 1 else 9)\n")
    argv = ["-H", "localhost:2", "--elastic=2", "--", sys.executable,
            str(probe)]
    (jrc, jout, jerr), (rc, out, err) = _both(argv, argv, _env())
    assert rc == jrc == 0, err
    assert "respawning as incarnation 1" in err
    assert sorted(out.splitlines()) == sorted(jout.splitlines())
    assert "probe pid=1 inc=1" in out
    assert _bfrun_lines(err) == _bfrun_lines(jerr)


def test_elastic_budget_exhaustion_is_terminal():
    argv = ["-H", "localhost:1", "--elastic=1", "--", sys.executable, "-c",
            "import sys; sys.exit(9)"]
    (jrc, _, jerr), (rc, _, err) = _both(argv, argv, _env())
    assert rc == jrc == 9, err
    assert "exhausted its restart budget" in err
    assert err.count("respawning") == 1  # budget=1: exactly one
    assert _bfrun_lines(err) == _bfrun_lines(jerr)


def test_elastic_min_world_teardown():
    argv = ["-H", "localhost:2", "--elastic=0", "--min-world", "2", "--",
            sys.executable, "-c",
            "import os, sys, time\n"
            f"if {_RANK} == '1':\n"
            "    sys.exit(9)\n"
            "time.sleep(60)\n"]
    t0 = time.monotonic()
    (jrc, _, jerr), (rc, _, err) = _both(argv, argv, _env())
    assert rc == jrc == 9, err
    assert "dropped below --min-world" in err
    assert _bfrun_lines(err) == _bfrun_lines(jerr)
    assert time.monotonic() - t0 < 45


# ---------------------------------------------------------------------------
# jobs launched through the port
# ---------------------------------------------------------------------------

def _port_job(argv, env, cwd, timeout=LAUNCH_TIMEOUT):
    return subprocess.run(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher"] + argv,
        env=env, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_simulate_single_host(tmp_path):
    """``--simulate 4``: four gloo processes, each of size 4 on the CPU,
    ranks 0-3 once each."""
    code = ("import os, bluefog_tpu_torch as bf; bf.init(); "
            "st = bf.runtime.state._global_state(); "
            "os.write(1, f'SIM {bf.rank()} {bf.size()} {st.device.type} "
            "{bf.local_rank()} {bf.local_size()}\\n'.encode()); "
            "bf.shutdown()")
    out = _port_job(["--simulate", "4", "--", sys.executable, "-c", code],
                    _env(tmp_path), tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = sorted(ln for ln in out.stdout.splitlines()
                   if ln.startswith("SIM "))
    assert lines == [f"SIM {r} 4 cpu {r} 4" for r in range(4)]


def _launch_pair(mode: str, env, cwd, timeout=LAUNCH_TIMEOUT):
    """Two processes started by hand with ``-np 2 --coordinator
    --process-id``, the exec mode's multi-host form; (codes, outputs)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bluefog_tpu_torch.launcher", "-np", "2",
         "--coordinator", f"127.0.0.1:{port}", "--process-id", str(i),
         "--", sys.executable, CHILD, mode, "--device", "cpu"],
        env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def test_two_process_manual_launch(tmp_path):
    """The exec mode's ``-np 2`` by hand, one command per process: the
    ranks meet through ``torchrun``'s environment, attach the control
    plane and agree on a collective, a combine and a counter."""
    codes, outs = _launch_pair("smoke", _env(tmp_path), tmp_path)
    for i in range(2):
        assert codes[i] == 0, outs[i]
        assert f"CHILD_OK {i}" in outs[i]


def test_four_process_fanout_one_command(tmp_path):
    """The four-controller job through ONE ``-H localhost:4`` command:
    the fan-out assigns the ranks and the coordinator and mints the
    control-plane secret for all four processes."""
    out = _port_job(
        ["-H", "localhost:4", "--simulate", "1", "--", sys.executable,
         CHILD, "quad"], _env(tmp_path, BFT_TOPO_CHECK_TIMEOUT="3"),
        tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    for i in range(4):
        for marker in ("PHASE_A_OK", "PHASE_D_AGREED",
                       "PHASE_D_DIVERGENT_RAISED", "PHASE_E_FENCE_OK",
                       "CHILD_OK"):
            assert f"{marker} {i}" in out.stdout, out.stdout
    assert "PHASE_B_MASS 120.0" in out.stdout


def test_one_of_four_crash_detected_by_all_survivors(tmp_path):
    """Controller 3 of 4 dies silently; EVERY survivor's heartbeat names it
    dead and a collective that needs it raises naming it. ``--elastic=0
    --min-world 3`` keeps the survivors running past the crash (the
    fan-out would otherwise kill the job at the first failure), and the
    job's exit code is the crash's."""
    out = _port_job(
        ["-H", "localhost:4", "--simulate", "1", "--elastic=0",
         "--min-world", "3", "--", sys.executable, CHILD, "fault"],
        _env(tmp_path, BFT_HEARTBEAT_INTERVAL="0.2",
             BFT_HEARTBEAT_TIMEOUT="1.5"), tmp_path)
    assert out.returncode == 17, out.stdout + out.stderr
    assert "rank 3 exited with 17 and exhausted its restart budget" in \
        out.stderr
    for i in range(3):
        assert f"SURVIVOR_DETECTED {i}" in out.stdout, out.stdout
        assert f"SURVIVOR_SYNC_RAISED {i}" in out.stdout, out.stdout
    for i in range(4):
        assert f"HEALTHY {i}" in out.stdout


def test_fanout_with_shard_servers(tmp_path):
    """``--cp-shards 2`` under the fan-out: the launcher starts two shard
    servers, exports their endpoints, and the ranks route over them."""
    out = _port_job(
        ["-H", "localhost:2", "--simulate", "1", "--cp-shards", "2", "--",
         sys.executable, CHILD, "smoke"], _env(tmp_path), tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "control plane sharded over 2 server(s)" in out.stderr
    for i in range(2):
        assert f"CHILD_OK {i}" in out.stdout


@pytest.mark.slow
def test_hostfile_fanout_two_processes(tmp_path):
    """ONE command drives a 2-process job from a hostfile: automatic
    ranks and coordinator, aggregated exit codes."""
    hf = tmp_path / "hosts"
    hf.write_text("localhost slots=2\n")
    out = _port_job(["--hostfile", str(hf), "--simulate", "1", "--",
                     sys.executable, CHILD, "smoke"], _env(tmp_path),
                    tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "CHILD_OK 0" in out.stdout and "CHILD_OK 1" in out.stdout


@pytest.mark.slow
def test_fanout_aggregates_failure(tmp_path):
    """A failing process makes the launcher kill the job and report its
    code."""
    code = ("import os, sys, time; "
            "sys.exit(7) if os.environ['RANK'] == '1' else time.sleep(60)")
    t0 = time.monotonic()
    out = _port_job(["-H", "localhost:2", "--", sys.executable, "-c", code],
                    _env(tmp_path), tmp_path, timeout=120)
    assert out.returncode == 7, (out.returncode, out.stdout + out.stderr)
    # the survivor slept 60s; first-failure kill must not wait it out
    assert time.monotonic() - t0 < 45


@pytest.mark.slow
def test_one_sided_windows_across_controllers(tmp_path):
    codes, outs = _launch_pair("onesided", _env(tmp_path), tmp_path)
    for i in range(2):
        assert codes[i] == 0, outs[i]
        assert f"CHILD_OK {i}" in outs[i]
    assert "PHASE_A_BOUNDED" in outs[0]


@pytest.mark.slow
def test_cross_controller_topo_check(tmp_path):
    codes, outs = _launch_pair(
        "topo", _env(tmp_path, BFT_TOPO_CHECK_TIMEOUT="3"), tmp_path)
    for i in range(2):
        assert codes[i] == 0, outs[i]
        for marker in ("AGREED_OK", "DIVERGENT_RAISED", "CHILD_OK"):
            assert f"{marker} {i}" in outs[i], outs[i]


@pytest.mark.slow
def test_peer_crash_detected(tmp_path):
    codes, outs = _launch_pair(
        "fault", _env(tmp_path, BFT_HEARTBEAT_INTERVAL="0.2",
                      BFT_HEARTBEAT_TIMEOUT="1.5"), tmp_path)
    assert codes[1] == 17, outs[1]
    assert codes[0] == 0, outs[0]
    assert "SURVIVOR_DETECTED 0" in outs[0]
    assert "SURVIVOR_SYNC_RAISED 0" in outs[0]
    assert "HEALTHY 0" in outs[0] and "HEALTHY 1" in outs[1]
