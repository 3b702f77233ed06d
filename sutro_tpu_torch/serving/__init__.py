"""Online serving tier: OpenAI-compatible interactive requests
co-scheduled with batch jobs in the same continuous-batch window (the
port of ``sutro_tpu/serving/``).

- :mod:`.openai` — request parsing + response/chunk builders shared by
  the HTTP surface (server.py ``/v1/*``) and the SDK's local path.
- :mod:`.channel` — the per-request in-memory streaming channel
  (scheduler thread -> consumer thread) that replaces the jobstore for
  interactive results.
- :mod:`.gateway` — admission, latency-priority scheduling glue
  (priority ``-1`` + the ``interactive_slots`` preemption budget), and
  terminal accounting (TTFT/ITL histograms, outcome counters).

Everything is gated on ``EngineConfig.interactive_slots > 0``; at the
default 0 the package is never imported by the engine.
"""

from .channel import StreamChannel
from .gateway import GatewayRejected, InteractiveGateway, InteractiveRequest
from .openai import BadServingRequest, ServingRequest, parse_request

__all__ = [
    "StreamChannel",
    "GatewayRejected",
    "InteractiveGateway",
    "InteractiveRequest",
    "BadServingRequest",
    "ServingRequest",
    "parse_request",
]
