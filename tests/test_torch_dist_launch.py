"""`python -m paddle_tpu_torch.distributed.launch` (and `spawn`): real rank
processes on the CPU (gloo), as `tests/test_dist_cluster.py` runs the JAX
package's launcher.

- Two ranks launched by the port's launcher train data-parallel through
  `make_sharded_train_step`; their per-step losses equal one process's
  (launched alone) within rtol 2e-4 / atol 2e-5
  (`tests/test_dist_cluster.py:91-92`), and fall.
- The watchdog: a rank that exits non-zero stops the job with its code,
  and the other rank is terminated, not waited for.
- `distributed.spawn`: two ranks of a module-level function join one
  world; a failing rank stops the other and raises.
Each launch has its own free port and a timeout that kills it.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_dist_ranks.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in list(env):
        if k.startswith("PADDLE_"):
            env.pop(k)
    return env


def _launch(nproc, args, log_dir, timeout=150):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--started_port",
           str(_free_port()), "--log_dir", log_dir] + args
    return subprocess.run(cmd, env=_env(), cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def _logs(log_dir):
    out = ""
    for name in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, name)) as f:
            out += f"--- {name}\n{f.read()[-2000:]}\n"
    return out


def test_launched_ranks_train_as_one_process(tmp_path):
    single, multi = str(tmp_path / "single.json"), str(tmp_path / "multi.json")
    for n, path in ((1, single), (2, multi)):
        log = str(tmp_path / f"log{n}")
        r = _launch(n, [SCRIPT, "launch_train", path], log)
        assert r.returncode == 0, (r.stderr[-1500:], _logs(log))
    with open(single) as f:
        s = json.load(f)
    with open(multi) as f:
        m = json.load(f)
    assert s["world"] == 1 and m["world"] == 2
    np.testing.assert_allclose(m["losses"], s["losses"], rtol=2e-4,
                               atol=2e-5)
    assert s["losses"][-1] < s["losses"][0]


def test_watchdog_stops_the_job_on_a_failed_rank(tmp_path):
    bad = tmp_path / "bad_script.py"
    bad.write_text(
        "import os, sys, time\n"
        "if os.environ.get('PADDLE_TRAINER_ID') == '1':\n"
        "    sys.exit(7)\n"
        "time.sleep(120)\n")
    t0 = time.monotonic()
    r = _launch(2, [str(bad)], str(tmp_path / "log"), timeout=100)
    assert r.returncode == 7, (r.returncode, r.stderr[-800:])
    assert "FAILED" in r.stderr
    # rank 0 was terminated, not waited for
    assert time.monotonic() - t0 < 60
    for rank in (0, 1):
        assert os.path.exists(tmp_path / "log" / f"workerlog.{rank}")


def test_spawn_joins_one_world_and_stops_on_a_failure(tmp_path):
    import pytest
    from paddle_tpu_torch import distributed as D
    from torch_dist_ranks import spawn_probe
    path = str(tmp_path / "probe")
    D.spawn(spawn_probe, args=(path,), nprocs=2, timeout=90)
    for rank in (0, 1):
        with open(f"{path}.{rank}") as f:
            assert json.load(f) == {"sum": 3.0, "world": 2}
    with pytest.raises(RuntimeError, match="exited with code 3"):
        D.spawn(spawn_probe, args=(path + "x", 1), nprocs=2, timeout=90)
