"""ray_tpu_torch.serve — model serving on actors; a copy of
``ray_tpu.serve`` on the port's runtime.

Reference: Ray Serve (``python/ray/serve/``, SURVEY §2.3/§3.5): a
controller actor reconciles declarative deployment state into replica
actors; handles/proxies route requests with power-of-two-choices on
queue length; autoscaling reacts to queue metrics; ``@serve.batch``
coalesces concurrent requests for batched inference — the essential
feature for GPU replicas, where batch = tensor-core utilization. A
replica that asks for ``ray_actor_options={"num_gpus": 1}`` holds a card
of its own; a torch tensor it returns crosses the store as any task's
does, so a CUDA tensor reaches only callers that see a card (return CPU
tensors to HTTP and gRPC callers).

Surface: ``@serve.deployment`` → ``serve.run(app)`` → handle, plus an
optional stdlib HTTP gateway (``serve.start_http``). gRPC (``grpcio``)
is imported only where the gRPC ingress starts or is called.
"""

from .api import (  # noqa: F401
    delete,
    deployment,
    get_deployment_handle,
    run,
    shutdown,
    start,
    start_grpc,
    start_http,
    stop_grpc,
    stop_http,
)
from .grpc_ingress import grpc_call, grpc_stream  # noqa: F401
from .batching import batch  # noqa: F401
from .handle import DeploymentHandle  # noqa: F401
from .multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from .proxy import proxy_addresses  # noqa: F401
from .request_context import get_request_id  # noqa: F401
