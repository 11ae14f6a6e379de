"""``python -m easydl_tpu_torch.serve`` — one serving-replica process.

The SIGKILL-able unit of the serve fleet: builds a registry-backed
sharded PS read client (hot-id cached; quantized pulls per the
``EASYDL_PS_PULL_I8`` knob), wraps it in a :class:`ServeFrontend`, and
publishes itself for router discovery under ``<workdir>/serve/``.
:func:`easydl_tpu_torch.serve.launch.spawn_replicas` launches several of
these; production would run one per pod, exactly like the PS entrypoint.

The default scorer is the deterministic numpy fallback — scores are a
pure function of the pulled rows, which is what lets the drills verify
freshness BIT-EXACTLY from the outside. ``--deepfm`` swaps in DeepFM's
dense tower (``--hidden``, default one layer of 64 as in the JAX
package) on the card, or on the CPU with ``--device cpu``; on a box
without a card ``--deepfm`` alone fails. Without ``--deepfm`` the
replica touches no card. ``--device-ms`` adds a fixed per-batch service
floor standing in for an accelerator-bound forward on boxes that have
none.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from easydl_tpu_torch.ps.client import ShardedPsClient
from easydl_tpu_torch.ps.read_client import PsReadClient
from easydl_tpu_torch.serve.cache import HotIdCache
from easydl_tpu_torch.serve.frontend import (
    ServeConfig,
    ServeFrontend,
    _numpy_forward,
    make_deepfm_forward,
)
from easydl_tpu_torch.utils.logging import get_logger

log = get_logger("serve", "main")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="easydl serving replica")
    ap.add_argument("--workdir", required=True,
                    help="job workdir (PS registry + serve discovery)")
    ap.add_argument("--name", required=True, help="replica name")
    ap.add_argument("--table", required=True)
    ap.add_argument("--fields", type=int, required=True)
    ap.add_argument("--dense-dim", type=int, default=0)
    ap.add_argument("--dim", type=int, default=16,
                    help="embedding dim (deepfm forward only)")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-pending", type=int, default=2048)
    ap.add_argument("--cache-mb", type=int, default=32)
    ap.add_argument("--shards", type=int, default=None,
                    help="PS shard count (default: registry discovery)")
    ap.add_argument("--deepfm", action="store_true",
                    help="DeepFM's dense tower instead of the "
                         "deterministic numpy scorer")
    ap.add_argument("--hidden", default="64",
                    help="the tower's widths, comma-separated (deepfm "
                         "forward only; config 5's: 400,400,400)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the deepfm forward runs")
    ap.add_argument("--device-ms", type=float, default=0.0,
                    help="fixed per-batch service floor (simulated "
                         "accelerator time; 0 = none)")
    args = ap.parse_args(argv)
    if args.deepfm:
        from easydl_tpu_torch.utils.device import no_tf32, require_device

        require_device(args.device)  # before any pod is dialled
        no_tf32()

    client = ShardedPsClient.from_registry(
        args.workdir, args.shards, timeout=10.0,
        drain_retry_s=60.0, transient_retry_s=30.0)
    reads = PsReadClient(client, cache=HotIdCache(args.cache_mb << 20))
    if args.deepfm:
        forward = make_deepfm_forward(
            args.fields, args.dim, args.dense_dim,
            hidden=tuple(int(w) for w in args.hidden.split(",")),
            max_batch=args.max_batch, device=args.device)
    else:
        forward = _numpy_forward
    if args.device_ms > 0:
        inner = forward
        floor_s = args.device_ms / 1000.0

        def forward(emb, dense):  # noqa: F811 - deliberate wrap
            t0 = time.monotonic()
            out = inner(emb, dense)
            rest = floor_s - (time.monotonic() - t0)
            if rest > 0:
                time.sleep(rest)
            return out

    frontend = ServeFrontend(
        reads,
        ServeConfig(table=args.table, fields=args.fields,
                    dense_dim=args.dense_dim, max_batch=args.max_batch,
                    max_wait_ms=args.max_wait_ms,
                    max_pending=args.max_pending),
        forward=forward, name=args.name)
    frontend.serve(port=args.port, obs_workdir=args.workdir,
                   obs_name=args.name)

    stop = threading.Event()

    def _sig(_s, _f):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    log.info("serving replica %s up (table %s)", args.name, args.table)
    while not stop.is_set():
        stop.wait(0.5)
    frontend.stop()
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
