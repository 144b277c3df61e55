"""Workload modeling: stochastic mixed traffic for honest serving numbers.

The port of butterfly_tpu/workload/:

  models.py    composable request-population specs (length
               distributions, shared-prefix cohorts, priority/deadline
               mix) with seeded, reproducible trace generation
  arrivals.py  open-loop arrival processes (Poisson, bursty Markov-
               modulated on/off, ramp-to-saturation)
  sweep.py     operating-point sweep engine: one workload across a
               decode_steps_per_tick x inflight_blocks grid, emitting
               the latency/throughput curve + knee point
  replay.py    JSONL trace files + absolute-time open-loop replay at
               a live server / router / control-plane URL
  loadgen.py   the load generator (closed-loop clients, the fleet soak,
               open-loop workloads), a copy of tools/loadgen.py

models, arrivals, replay and loadgen are stdlib-only copies of the JAX
package's (and of tools/loadgen.py), so the same (spec, seed) gives the
same trace in both; sweep drives an in-process Scheduler and imports
the engine lazily.
"""
from butterfly_tpu_torch.workload.arrivals import (  # noqa: F401
    MarkovOnOff,
    Poisson,
    Ramp,
    assign_arrivals,
    parse_arrival,
)
from butterfly_tpu_torch.workload.models import (  # noqa: F401
    WORKLOADS,
    Cohort,
    LogNormal,
    RequestSpec,
    Uniform,
    Workload,
    get_workload,
    mixed_chat,
)
