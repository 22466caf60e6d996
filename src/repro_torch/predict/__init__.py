"""Output-length prediction plane (predicted-length scheduling).

Pluggable predictors (:class:`LengthPredictor` protocol) that estimate a
request's output-token count at ingest and its remaining work at decode
time, feeding EWSJF scoring/queueing (``Request.work_len``), cluster
routing and admission (predicted KV-seconds / TBT burn), and decode-time
preemption-victim selection.  Predictor-off — or a predictor that
abstains — is bit-identical to the length-blind scheduler."""

from .empirical import EmpiricalLengthPredictor, merge_states
from .predictor import (LengthPrediction, LengthPredictor,
                        OracleNoisePredictor, gittins_index,
                        work_equivalent_extra)
from .workload import HeavyTailDecodeSpec

__all__ = [
    "EmpiricalLengthPredictor",
    "HeavyTailDecodeSpec",
    "LengthPrediction",
    "LengthPredictor",
    "OracleNoisePredictor",
    "gittins_index",
    "merge_states",
    "work_equivalent_extra",
]
