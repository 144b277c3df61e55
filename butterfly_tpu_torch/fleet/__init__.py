"""Fleet control plane: disaggregated prefill/decode serving.

Grows the multi-replica router (router/) into a KV-aware control plane
(the DistServe / Mooncake architecture): prefill-heavy requests run on
prefill-role replicas, their KV pages stream to a decode-role replica
by content hash (fleet/kvtransfer.py over the prefix-cache page
registry), and generation finishes there.

* kvtransfer.py   — chain-hash-addressed KV page export/import payloads
                    (the replica side of GET /kv/pages, POST /kv/import)
* controlplane.py — the routing tier: request classification, the
                    prefill -> transfer -> decode handoff, fleet-state
                    polling, GET /fleet/state
* harness.py      — in-process fleet topologies (`butterfly fleet
                    --topology 2p2d`, the fleet tests, the fleet bench)
* autoscale.py    — the closed-loop autoscaler over a live fleet
* chaos.py        — seeded fault-injection plans for the fleet soak

The port of butterfly_tpu/fleet/: every module but harness.py is a copy
(stdlib, or numpy for the payload); harness.py builds the replicas on
the port's engine and device.
"""
from butterfly_tpu_torch.fleet.kvtransfer import (export_payload,
                                                  import_payload)

__all__ = ["export_payload", "import_payload"]
