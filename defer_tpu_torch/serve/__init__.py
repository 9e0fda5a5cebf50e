"""Serving front door: multi-tenant admission, continuous batching, and
SLO-aware shedding (the port of ``defer_tpu.serve``).

A deployment streams one client's inputs through the pipeline; this
package is the layer that turns that single stream into a *service*:

* :mod:`admission` — per-tenant weighted-fair queuing with priorities
  and SLO-aware load shedding (reject at admission when the predicted
  queueing delay blows the request's deadline).
* :mod:`batcher` — continuous batching: coalesce admitted samples
  across tenants into fixed-width frames.
* :mod:`frontdoor` — the TCP front door: many concurrent client
  streams multiplexed onto one deployed chain (tenant + request ids
  ride ``req_meta`` control frames through the chain and are
  demultiplexed on the result hop) or onto one decode engine,
  per-tenant telemetry.
* :mod:`engine` — continuous-batching autoregressive decode
  (``models/gpt.py`` graphs): requests join and leave a fixed set of
  KV slots between decode steps; one CUDA-graph replay per step on the
  card.
* :mod:`client` — the framed-protocol client and an open-loop load
  generator driven by :mod:`arrivals` traces.
"""

from .admission import (AdmissionController, ShedDecision, TenantConfig,
                        WeightedFairQueue)
from .arrivals import poisson_trace
from .batcher import BatchFormer, max_batch_within_budget
from .client import LoadGenerator, ServeClient
from .engine import ContinuousBatchEngine, DecodeRequest
from .frontdoor import ServeFrontDoor

__all__ = [
    "AdmissionController", "BatchFormer", "ContinuousBatchEngine",
    "DecodeRequest", "LoadGenerator", "ServeClient", "ServeFrontDoor",
    "ShedDecision", "TenantConfig", "WeightedFairQueue",
    "max_batch_within_budget", "poisson_trace",
]
