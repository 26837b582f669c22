"""Serving plane — the continuous-batching generation service (torch twin
of ``gan_deeplearning4j_tpu/serve/``).

``parallel/inference.py`` runs ONE bucketed dispatch, a CUDA graph per
bucket on the card; this package turns it into a service: an
admission-controlled request queue (``admission.py``) drained by a
dedicated dispatch thread (``engine.py``) that coalesces concurrent
requests into the next bucketed dispatch, an open-loop Poisson load
harness (``loadgen.py``) that measures p50/p95/p99 and saturation
throughput, and the network front door: an HTTP gateway (``gateway.py``)
over a health-aware replica router (``router.py``) with a retrying
reference client (``client.py``); ``replica.py`` runs the stack as a
standalone process.  Across processes, ``mesh.py`` routes over replica
processes by their HTTP surface (typed ejection and re-probe), and
``controlplane.py`` spawns them, heals, autoscales and canary-deploys
checkpoints.  The wire formats, the trace header, error types, status
codes and report keys are the JAX package's.

``publisher.py`` carries every verified checkpoint of a trainer's
directory (single-model or fleet) through the control plane's canary
deployment; ``router.py``'s ``FleetTenantBank`` serves each tenant of a
fleet checkpoint from its own engine (``replica --fleet``).
"""

from gan_deeplearning4j_tpu_torch.serve.admission import (
    AdmissionQueue,
    Request,
    ShedError,
)
from gan_deeplearning4j_tpu_torch.serve.client import (
    GatewayClient,
    GatewayHTTPError,
)
from gan_deeplearning4j_tpu_torch.serve.controlplane import (
    Autoscaler,
    CanaryDeployment,
    ControlPlane,
    DeploymentRollbackError,
    ReplicaLauncher,
    ReplicaProcess,
    ReplicaSpawnError,
)
from gan_deeplearning4j_tpu_torch.serve.engine import DispatchError, ServeEngine
from gan_deeplearning4j_tpu_torch.serve.gateway import Gateway, TokenBucket
from gan_deeplearning4j_tpu_torch.serve.loadgen import (
    measure_saturation,
    percentiles,
    run_load,
    run_socket_load,
    z_inputs,
)
from gan_deeplearning4j_tpu_torch.serve.mesh import (
    MeshRouter,
    RemoteReplica,
    ReplicaProbeError,
)
from gan_deeplearning4j_tpu_torch.serve.publisher import (
    CheckpointPublisher,
    finite_params_probe,
)
from gan_deeplearning4j_tpu_torch.serve.router import (
    FleetTenantBank,
    NoHealthyReplicaError,
    Router,
    TenantThrottledError,
)

__all__ = [
    "AdmissionQueue",
    "Autoscaler",
    "CanaryDeployment",
    "CheckpointPublisher",
    "ControlPlane",
    "DeploymentRollbackError",
    "DispatchError",
    "FleetTenantBank",
    "Gateway",
    "GatewayClient",
    "GatewayHTTPError",
    "MeshRouter",
    "NoHealthyReplicaError",
    "RemoteReplica",
    "ReplicaLauncher",
    "ReplicaProbeError",
    "ReplicaProcess",
    "ReplicaSpawnError",
    "Request",
    "Router",
    "ServeEngine",
    "ShedError",
    "TenantThrottledError",
    "TokenBucket",
    "finite_params_probe",
    "measure_saturation",
    "percentiles",
    "run_load",
    "run_socket_load",
    "z_inputs",
]
