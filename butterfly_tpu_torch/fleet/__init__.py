"""Fleet: the replica side of disaggregated prefill/decode serving.

* kvtransfer.py — chain-hash-addressed KV page export/import payloads
                  (the replica side of GET /kv/pages, POST /kv/import)

The JAX package's control plane and in-process fleet harness are not
carried over yet.
"""
from butterfly_tpu_torch.fleet.kvtransfer import (export_payload,
                                                  import_payload)

__all__ = ["export_payload", "import_payload"]
