"""Multi-process launcher (port of cerebra/cli/launch.py; the torchrun /
torch.multiprocessing.spawn of EEG-BarlowNetworks/train.py:53-78).

Starts N copies of a command with the env:// variables torch reads
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK; the port's
`init_distributed` brings the process group up from them), prefixes each
rank's output lines with `[rankN]`, and on the first non-zero exit
terminates the surviving ranks and returns that code.

    python -m cerebra_torch.cli.launch --nproc 2 -- \\
        python -m cerebra_torch.cli.lstm_distill_from_dinov2_train --synthetic ...

A CLI given `--devices N > 1` outside a launched world runs itself as N
ranks through `run` (cli/common.py::run_as_ranks).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Mapping, Optional, Sequence


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pump(rank: int, proc: subprocess.Popen) -> None:
    for line in proc.stdout:  # type: ignore[union-attr]
        sys.stdout.write(f"[rank{rank}] {line}")
        sys.stdout.flush()


def run(nproc: int, cmd: Sequence[str], coordinator: str = "",
        env: Optional[Mapping[str, str]] = None) -> int:
    """Run `cmd` as ranks 0..nproc-1 of one world on this host, `env` added
    to each rank's environment → the first non-zero exit code, else 0. Each
    rank's CPU threads default to its share of the host's cores (torchrun's
    OMP_NUM_THREADS rule): N ranks of a full-width thread pool each spin
    against one another."""
    host, _, port = (coordinator or f"localhost:{_free_port()}").rpartition(":")
    threads = {"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // max(nproc, 1)))}
    procs, pumps = [], []
    for rank in range(nproc):
        rank_env = {**threads, **os.environ, **(env or {}), "MASTER_ADDR": host or "localhost",
                    "MASTER_PORT": port, "RANK": str(rank), "WORLD_SIZE": str(nproc),
                    "LOCAL_RANK": str(rank)}
        p = subprocess.Popen(list(cmd), env=rank_env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        t = threading.Thread(target=_pump, args=(rank, p), daemon=True)
        t.start()
        procs.append(p)
        pumps.append(t)
    # the first non-zero exit terminates the survivors, which would otherwise
    # wait forever in the next collective for the rank that died
    rc = 0
    live = dict(enumerate(procs))
    try:
        while live:
            for rank in list(live):
                code = live[rank].poll()
                if code is None:
                    continue
                del live[rank]
                if code != 0:
                    print(f"[launch] rank {rank} exited with {code}; terminating the "
                          f"remaining ranks", file=sys.stderr)
                    rc = rc or code
                    break
            if rc:
                break
            time.sleep(0.1)
    finally:
        for p in live.values():
            p.terminate()
        for p in live.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in pumps:
            t.join(timeout=5)
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("cerebra_torch.launch",
                                     description="start N distributed worker processes")
    parser.add_argument("--nproc", type=int, default=1)
    parser.add_argument("--coordinator", type=str, default="",
                        help="host:port rendezvous (default: localhost:<free port>)")
    parser.add_argument("cmd", nargs=argparse.REMAINDER, help="worker command after `--`")
    FLAGS = parser.parse_args(argv)
    cmd = FLAGS.cmd[1:] if FLAGS.cmd and FLAGS.cmd[0] == "--" else FLAGS.cmd
    if not cmd:
        parser.error("no worker command given (use: launch --nproc N -- <cmd>)")
    return run(FLAGS.nproc, cmd, FLAGS.coordinator)


if __name__ == "__main__":
    raise SystemExit(main())
