"""PyTorch port: the flight recorder's SLO-burn trigger
(obs/ticklog.py:FlightRecorder.poll) and the time-series alert rules
(obs/timeseries.py:evaluate_rules) against the JAX package's copies on
the same inputs, on the CPU.

Held: the same notes and polls give the same artifact (reason, signals,
event counts) and trigger counts, an idle setup (threshold 0, burn 0)
never fires; the same rules over the same sample sequences fire the
same alerts (a single hot sample or a run short of the window stays
silent, a full window fires and latches, drift needs two windows).
"""
import pytest

from butterfly_tpu.obs.ticklog import FlightRecorder as JFlightRecorder
from butterfly_tpu.obs.timeseries import (AlertRule as JAlertRule,
                                          evaluate_rules as jevaluate)
from butterfly_tpu_torch.obs.ticklog import FlightRecorder
from butterfly_tpu_torch.obs.timeseries import AlertRule, evaluate_rules


def _samples(values, signal="s"):
    """Ring entries for one signal's value sequence."""
    return [{"seq": i, "signals": {signal: v}} for i, v in enumerate(values)]


def _burn_run(cls, threshold, burns):
    """What a recorder of `cls` returns for each poll of `burns` after
    one admit note: (reason, slo_burn_rate signal, event counts) or
    None, then its dump's triggers_fired."""
    fr = cls(slo_burn_threshold=threshold)
    fr.note("admit", id=0)
    out = []
    for b in burns:
        art = fr.poll({"slo_burn_rate": b})
        out.append(None if art is None else (
            art["reason"], art["signals"]["slo_burn_rate"],
            art["event_counts"]))
    return out, fr.dump()["triggers_fired"]


@pytest.mark.parametrize("threshold,burns", [
    (0.5, [0.4, 0.6]),
    (0.0, [0.0, 0.0]),
    (0.25, [0.1, 0.25, 0.3]),
])
def test_slo_burn_trigger_matches_jax(threshold, burns):
    """Polls below the threshold stay quiet, the first at or above it
    dumps with reason slo_burn and the cooldown keeps the next one quiet
    (a burn of 0 never fires), as in the JAX package."""
    got = _burn_run(FlightRecorder, threshold, burns)
    assert got == _burn_run(JFlightRecorder, threshold, burns)
    first = [b >= threshold > 0 for b in burns].index(True) \
        if threshold > 0 else None
    assert [a is not None for a in got[0]] == [
        i == first for i in range(len(burns))]
    if first is not None:
        assert got[0][first][0] == "slo_burn"


#: (rule arguments, the value sequences evaluated in turn on one rule)
ALERT_CASES = [
    (("burn", "s", 5, "sustained_above", 0.5), [[0.9], [0.9] * 4]),
    (("burn", "s", 3, "sustained_above", 0.5),
     [[0.9, 0.8, 0.7], [0.9, 0.8, 0.7, 0.6], [0.7, 0.6, 0.1],
      [0.1, 0.9, 0.9, 0.9]]),
    (("drift", "s", 3, "drift_above", 0.5),
     [[1.0, 1.0, 1.0, 2.0, 2.0, 2.0]]),
    (("drift", "s", 3, "drift_above", 0.5), [[2.0, 2.0, 2.0]]),
]


@pytest.mark.parametrize("args,runs", ALERT_CASES)
def test_alert_rules_match_jax(args, runs):
    """The same rule over the same sample sequences fires the same
    alerts as the JAX package's evaluate_rules: nothing short of the
    window, one alert a full excursion."""
    rule, jrule = AlertRule(*args), JAlertRule(*args)
    fired = []
    for values in runs:
        got = evaluate_rules([rule], _samples(values))
        assert got == jevaluate([jrule], _samples(values))
        fired.append(len(got))
    if args[2] == 5:
        assert fired == [0, 0]
    elif args[3] == "sustained_above":
        assert fired == [1, 0, 0, 1]
