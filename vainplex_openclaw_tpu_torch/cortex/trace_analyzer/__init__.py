"""Trace analyzer: batch failure analysis over the agent event history,
the port's copy of ``vainplex_openclaw_tpu/cortex/trace_analyzer``.

Pipeline: fetch events from a TraceSource → normalize (dual schema) →
reconstruct conversation chains → run 7 signal detectors (the doom-loop
windows through the batched Levenshtein program, K3 on the card) →
optional classification (local triage on the port's encoder, K1) →
deduped outputs → failure clusters (Jaccard blocks on the card) → report +
incremental state. The stage-2 classifier and the redactor live here too.
"""

from .analyzer import TraceAnalyzer
from .chains import ConversationChain, reconstruct_chains
from .clusters import IncrementalClusterer, cluster_failure_signals
from .events import NormalizedEvent, detect_schema, map_event_type, normalize_event
from .signals import FailureSignal, detect_all_signals
from .source import MemoryTraceSource, TransportTraceSource, create_nats_trace_source

__all__ = [
    "ConversationChain",
    "FailureSignal",
    "IncrementalClusterer",
    "MemoryTraceSource",
    "NormalizedEvent",
    "TraceAnalyzer",
    "TransportTraceSource",
    "cluster_failure_signals",
    "create_nats_trace_source",
    "detect_all_signals",
    "detect_schema",
    "map_event_type",
    "normalize_event",
    "reconstruct_chains",
]
