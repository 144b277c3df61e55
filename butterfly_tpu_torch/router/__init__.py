"""Multi-replica routing tier: a stdlib-only front end over N backend
`butterfly serve` replicas.

Layer map:
  pool.py    replica membership + health: polls each backend's
             GET /health, tracks live/degraded/draining/dead with
             jittered exponential backoff on dead-replica re-probe
  policy.py  routing decisions: prefix-affinity consistent-hash ring
             (same page-block hashing as cache/prefix.py) with
             least-outstanding-requests fallback
  proxy.py   the HTTP tier: streaming-safe passthrough of /generate and
             /v1/completions, retry-before-first-byte failover, admin
             drain/undrain, and the router's own /metrics

The router multiplies effective KV-cache capacity: sending same-prefix
requests to the same replica means its PrefixCachingAllocator serves
their prompts from pages already in HBM (SGLang-style cache-aware
routing), while health-aware failover turns single-node continuous
batching into a fleet (vLLM-style deployments). A copy of
butterfly_tpu/router/.
"""
from butterfly_tpu_torch.router.policy import (  # noqa: F401
    PrefixAffinityPolicy)
from butterfly_tpu_torch.router.pool import Replica, ReplicaPool  # noqa: F401
from butterfly_tpu_torch.router.proxy import (  # noqa: F401
    RouterState, make_router_handler, route_forever)
