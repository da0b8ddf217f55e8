"""paddle_tpu_torch's elastic heartbeats and `launch --elastic`, the port's
counterparts of `tests/test_elastic.py` (the two packages' `elastic` and
`http_server` modules are the same plain Python; the launcher and the
heartbeat's start in `init_parallel_env` are the port's own).

- ranks beat through the KV server, a silent rank faults the job with
  its rank named, and a rank that comes back clears it;
- a clean exit is not a fault, and every rank exited is EXIT;
- two KV servers share no keys; `watch` fires on the fault transition;
- `launch --elastic` on 2 CPU ranks: a job whose ranks finish exits 0
  with its losses falling; a job with a rank
  that hangs before it ever beats is detected ("stopped heartbeating",
  rank 1 named) and killed, the launcher exiting non-zero.
"""
import json
import re
import time

from paddle_tpu_torch.distributed.fleet import (ElasticManager,
                                                ElasticStatus,
                                                HeartbeatClient, KVServer)

from test_torch_dist_launch import SCRIPT, _launch, _logs


def test_heartbeat_liveness_and_fault_detection():
    kv = KVServer().start()
    ep = f"127.0.0.1:{kv.port}"
    try:
        w0 = HeartbeatClient(ep, rank=0, interval=0.2).start()
        w1 = HeartbeatClient(ep, rank=1, interval=0.2).start()
        mgr = ElasticManager(ep, world_size=2, timeout=1.5)
        time.sleep(0.5)
        assert mgr.scan() == ElasticStatus.OK
        assert mgr.dead_ranks == []
        w1.stop()
        deadline = time.time() + 6
        while time.time() < deadline:
            if mgr.scan() == ElasticStatus.FAULT:
                break
            time.sleep(0.3)
        assert mgr.status == ElasticStatus.FAULT
        assert mgr.dead_ranks == [1]
        w1 = HeartbeatClient(ep, rank=1, interval=0.2).start()
        time.sleep(0.5)
        assert mgr.scan() == ElasticStatus.OK
        w0.stop()
        w1.stop()
    finally:
        kv.stop()


def test_clean_exit_is_not_a_fault():
    kv = KVServer().start()
    ep = f"127.0.0.1:{kv.port}"
    try:
        w0 = HeartbeatClient(ep, rank=0, interval=0.2).start()
        w1 = HeartbeatClient(ep, rank=1, interval=0.2).start()
        mgr = ElasticManager(ep, world_size=2, timeout=1.0)
        time.sleep(0.4)
        assert mgr.scan() == ElasticStatus.OK
        w0.stop(exited=True)
        time.sleep(1.5)
        assert mgr.scan() == ElasticStatus.OK
        w1.stop(exited=True)
        assert mgr.scan() == ElasticStatus.EXIT
    finally:
        kv.stop()


def test_kv_servers_are_isolated_and_watch_fires():
    a, b = KVServer().start(), KVServer().start()
    events = []
    try:
        HeartbeatClient(f"127.0.0.1:{a.port}", rank=0).beat_once()
        mgr_b = ElasticManager(f"127.0.0.1:{b.port}", world_size=1,
                               timeout=1.0, grace=0.0)
        assert mgr_b.scan() == ElasticStatus.FAULT
        w0 = HeartbeatClient(f"127.0.0.1:{a.port}", rank=0,
                             interval=0.2).start()
        mgr = ElasticManager(f"127.0.0.1:{a.port}", world_size=2,
                             timeout=1.5)
        mgr.watch(interval=0.3, on_fault=lambda dead: events.append(dead))
        deadline = time.time() + 8
        while time.time() < deadline and not events:
            time.sleep(0.2)
        assert events and events[0] == [1]
        mgr.stop()
        w0.stop()
    finally:
        a.stop()
        b.stop()


def test_launcher_elastic_runs_a_clean_job(tmp_path):
    """The beating ranks train data-parallel as without `--elastic`
    (`test_torch_dist_launch.py`'s job) and exit 0."""
    out = tmp_path / "losses.json"
    r = _launch(2, ["--elastic", SCRIPT, "launch_train", str(out)],
                str(tmp_path / "log"))
    assert r.returncode == 0, r.stderr + _logs(str(tmp_path / "log"))
    with open(out) as f:
        got = json.load(f)
    assert got["world"] == 2 and len(got["losses"]) == 5
    assert got["losses"][-1] < got["losses"][0]


def test_launcher_elastic_kills_a_hung_job(tmp_path):
    """Rank 1 never beats and is named (rank 0, which beats once it has
    imported, may be named beside it on a machine loaded enough to delay
    its first beat past the grace)."""
    t0 = time.monotonic()
    r = _launch(2, ["--elastic", "--elastic_timeout", "3",
                    "--elastic_grace", "8", SCRIPT, "elastic_hang",
                    str(tmp_path)], str(tmp_path / "log"), timeout=90)
    assert r.returncode != 0
    said = re.search(r"rank\(s\) \[([0-9, ]*)\] stopped heartbeating",
                     r.stderr)
    assert said and 1 in [int(x) for x in said.group(1).split(",")], \
        r.stderr
    assert time.monotonic() - t0 < 75
