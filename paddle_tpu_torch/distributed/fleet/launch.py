"""Launcher (port of `paddle_tpu.distributed.fleet.launch`; reference
`fleet/launch.py:208` launch_collective and `launch_utils.py:435, 494,
526`).

The JAX package starts one process a host (SPMD spans its chips); the
port starts one process a card. For each local rank it sets the PADDLE_*
contract `distributed.init_parallel_env` reads: PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK, PADDLE_MASTER (the first
endpoint, where rank 0 serves the rendezvous), PADDLE_CURRENT_ENDPOINT,
PADDLE_TRAINER_ENDPOINTS, TRAINING_ROLE; writes each rank's output to
`{log_dir}/workerlog.{rank}`; and watches the ranks: when one exits
non-zero the others are terminated (then killed after a grace period)
and the launcher exits with that code. Usage:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        train.py [args]

`--elastic` (reference `fleet/launch.py:31-37, 114-139`) also starts a
KV server (`http_server.KVServer`) and hands its endpoint to the ranks as
PADDLE_ELASTIC_KV, where `distributed.init_parallel_env` starts each
rank's heartbeat; an `elastic.ElasticManager` watches the ranks, and a
rank that never beats within `--elastic_grace` seconds or stops beating
for `--elastic_timeout` faults the job: the launcher prints "rank(s) [..]
stopped heartbeating", terminates the ranks and exits non-zero. A beat
proves the process alive, not its loop (see `elastic.HeartbeatClient`).
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

__all__ = ["launch", "main", "start_local_trainers", "watch_local_trainers"]

_GRACE_S = 10.0


def _parse(argv=None):
    p = argparse.ArgumentParser("fleet launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="ranks on this node (default: the CUDA cards, "
                        "else 1)")
    p.add_argument("--gpus", type=str, default=None,
                   help="comma-separated card ids: one rank each")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--run_mode", type=str, default="collective")
    p.add_argument("--elastic", action="store_true",
                   help="start a KV heartbeat monitor: ranks that die, "
                        "fail init, or stop beating fault the job")
    p.add_argument("--elastic_timeout", type=float, default=30.0)
    p.add_argument("--elastic_grace", type=float, default=120.0,
                   help="seconds a rank may take to its FIRST beat")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _nproc(args):
    if args.gpus:
        return len(args.gpus.split(","))
    if args.nproc_per_node:
        return args.nproc_per_node
    try:
        import torch
        return max(torch.cuda.device_count(), 1)
    except ImportError:
        return 1


def start_local_trainers(args, extra_env=None):
    """Start this node's ranks; returns [(Popen, log file, rank)]."""
    ips = args.ips.split(",")
    nproc = _nproc(args)
    world = len(ips) * nproc
    endpoints = [f"{ip}:{args.started_port + i}"
                 for ip in ips for i in range(nproc)]
    os.makedirs(args.log_dir, exist_ok=True)
    node = ips.index("127.0.0.1") if "127.0.0.1" in ips else 0
    procs = []
    for i in range(nproc):
        rank = node * nproc + i
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_LOCAL_RANK": str(i),
            "PADDLE_MASTER": endpoints[0],
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "TRAINING_ROLE": "TRAINER",
        })
        env.update(extra_env or {})
        logf = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
        cmd = [sys.executable, "-u", args.training_script] + \
            list(args.training_script_args)
        procs.append((subprocess.Popen(cmd, env=env, stdout=logf,
                                       stderr=subprocess.STDOUT), logf,
                      rank))
    return procs


def _stop(procs):
    for p, _, _ in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + _GRACE_S
    for p, _, _ in procs:
        try:
            p.wait(max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def watch_local_trainers(procs, poll_s=0.2, fault=None) -> int:
    """Wait for the ranks; the first non-zero exit terminates the rest
    and is returned (0 when every rank succeeds). `fault` (a
    threading.Event, set by the elastic monitor) terminates them too and
    returns 1."""
    try:
        alive = list(procs)
        while alive:
            if fault is not None and fault.is_set():
                _stop(procs)
                return 1
            still = []
            for p, logf, rank in alive:
                ret = p.poll()
                if ret is None:
                    still.append((p, logf, rank))
                elif ret != 0:
                    print(f"[launch] rank {rank} FAILED (exit {ret}); "
                          f"terminating the job", file=sys.stderr,
                          flush=True)
                    _stop(procs)
                    return ret
            alive = still
            time.sleep(poll_s)
        return 0
    except KeyboardInterrupt:
        _stop(procs)
        raise
    finally:
        for _, logf, _ in procs:
            logf.close()


def launch(argv=None):
    args = _parse(argv)
    if not args.elastic:
        procs = start_local_trainers(args)
        rc = watch_local_trainers(procs)
    else:
        import threading
        from .elastic import ElasticManager
        from .http_server import KVServer
        kv = KVServer().start()
        kv_ep = f"127.0.0.1:{kv.port}"
        procs = start_local_trainers(args, {"PADDLE_ELASTIC_KV": kv_ep})
        fault = threading.Event()

        def on_fault(dead):
            print(f"[launch] rank(s) {dead} stopped heartbeating; "
                  f"terminating the job", file=sys.stderr, flush=True)
            fault.set()
        mgr = ElasticManager(kv_ep, ranks=[r for _, _, r in procs],
                             timeout=args.elastic_timeout,
                             grace=args.elastic_grace).watch(
                                 interval=0.5, on_fault=on_fault)
        try:
            rc = watch_local_trainers(procs, fault=fault)
        finally:
            mgr.stop()
            kv.stop()
    if rc:
        sys.exit(rc)


main = launch

if __name__ == "__main__":
    launch()
