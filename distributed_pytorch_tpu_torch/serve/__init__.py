"""Online serving layer over engine/DecodeEngine: asyncio request
scheduler (scheduler.py), stdlib streaming HTTP front-end (server.py),
serve-side metrics (metrics.py) and the control-plane policies
(control.py). Start a replica with
`python -m distributed_pytorch_tpu_torch.serve --preset gpt2_124m` (random
weights at full width) or `--demo`. The router tier comes with a later
slice."""

from distributed_pytorch_tpu_torch.serve.metrics import (RouterMetrics,
                                                         ServeMetrics)
from distributed_pytorch_tpu_torch.serve.scheduler import (EngineError,
                                                           RequestHandle,
                                                           Scheduler,
                                                           ShedError)
from distributed_pytorch_tpu_torch.serve.server import ServeApp

__all__ = ["Scheduler", "RequestHandle", "ShedError", "EngineError",
           "ServeMetrics", "RouterMetrics", "ServeApp"]
