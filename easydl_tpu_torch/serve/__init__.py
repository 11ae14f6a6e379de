"""Online serving tier: stateless inference frontends over the live PS.

The training side of this repo writes embedding tables through the PS
push path; this package is the read side the north star promises
("serve heavy traffic from millions of users"): a batched
forward pass whose sparse rows are pulled READ-ONLY from the live PS
tier through :class:`easydl_tpu_torch.ps.read_client.PsReadClient` — the same
pull code path the trainer rides, so every wire win (raw_ids, fp16,
chunked concurrent transfers, stale-route handling) is inherited, never
reimplemented.

- :mod:`easydl_tpu_torch.serve.cache` — the hot-id client-side embedding
  cache (byte-bounded LRU, version/generation invalidated).
- :mod:`easydl_tpu_torch.serve.frontend` — micro-batching request queue
  with deadline-based admission control, the forward (DeepFM's tower on
  the card), the ``easydl.Serve`` gRPC service, and the
  ``easydl_serve_*`` telemetry.
- :mod:`easydl_tpu_torch.serve.routing` / :mod:`easydl_tpu_torch.serve.router` —
  the fleet layer: pure least-loaded + session-affinity dispatch policy,
  and the router that actuates it over every discovered replica with
  request hedging, ejection + hold-down, and fleet-wide load gauges.
"""

from easydl_tpu_torch.serve.cache import HotIdCache  # noqa: F401
from easydl_tpu_torch.serve.frontend import (  # noqa: F401
    SERVE_SERVICE,
    InferResult,
    ServeConfig,
    ServeFrontend,
)
from easydl_tpu_torch.serve.router import ServeRouter  # noqa: F401
from easydl_tpu_torch.serve.routing import ReplicaView, route_decision  # noqa: F401
