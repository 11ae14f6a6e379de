"""Spawn serving-replica subprocesses and wait for their discovery files.

The ONE copy of the launch-and-wait idiom: start N
``python -m easydl_tpu_torch.serve`` processes against a job workdir and
block until every replica has published ``<workdir>/serve/<name>.json`` —
the same files the router's discovery scans. A CLI-flag or discovery-
convention change lands here once, not in drifting copies.

``extra_args`` go on each replica's command line (``--deepfm``,
``--device cpu``, ...); ``log_path`` collects the replicas' output
(discarded by default).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn_replicas(n: int, workdir: str, table: str, fields: int,
                   device_ms: float = 0.0, max_batch: int = 256,
                   max_wait_ms: float = 2.0, max_pending: int = 2048,
                   cache_mb: int = 32,
                   extra_env: Optional[Dict[str, str]] = None,
                   wait_s: float = 90.0,
                   name_prefix: str = "serve-",
                   extra_args: Sequence[str] = (),
                   log_path: Optional[str] = None) -> Dict[str, object]:
    """Launch ``n`` replica processes; returns {name: Popen} once every
    one has published its discovery file (kills them all and raises on
    timeout)."""
    env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
    out = (open(log_path, "ab") if log_path is not None
           else subprocess.DEVNULL)
    procs: Dict[str, object] = {}
    for i in range(n):
        name = f"{name_prefix}{i}"
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "easydl_tpu_torch.serve",
             "--workdir", workdir, "--name", name,
             "--table", table, "--fields", str(int(fields)),
             "--max-batch", str(int(max_batch)),
             "--max-wait-ms", str(float(max_wait_ms)),
             "--max-pending", str(int(max_pending)),
             "--cache-mb", str(int(cache_mb)),
             "--device-ms", str(float(device_ms)), *extra_args],
            env=env, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    if log_path is not None:
        out.close()  # the children hold their own descriptors
    serve_dir = os.path.join(workdir, "serve")
    deadline = time.monotonic() + wait_s
    want = set(procs)
    while time.monotonic() < deadline:
        seen = ({os.path.splitext(f)[0] for f in os.listdir(serve_dir)
                 if f.endswith(".json")}
                if os.path.isdir(serve_dir) else set())
        if want <= seen:
            return procs
        time.sleep(0.1)
    for p in procs.values():
        p.kill()
    raise TimeoutError("serve replicas never published discovery files")
