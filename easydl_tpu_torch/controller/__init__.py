"""Control plane: the elastic operator (reference: elastic-operator,
README.md:12; docs/design/elastic-training-operator.md) — CR store as event
bus, level-triggered reconcile with a native C++ decision core, and a pod
API abstraction over k8s/fakes.
"""

from easydl_tpu_torch.controller.operator import (  # noqa: F401
    CrStore,
    ElasticJobController,
    JobStatus,
)
from easydl_tpu_torch.controller.pod_api import InMemoryPodApi, Pod, PodApi  # noqa: F401
from easydl_tpu_torch.controller.reconciler import (  # noqa: F401
    PodOp,
    reconcile,
    reconcile_wire,
    resource_sig,
)
