"""Conversation intelligence (reference: packages/openclaw-cortex).

Trackers (threads/decisions/commitments) fed by regex signal extraction over
10 language packs, boot-context generation for session resume, pre-compaction
snapshotting, optional LLM enhancement, read-only agent tools, and the batch
trace analyzer (``trace_analyzer`` subpackage), whose doom-loop detectors
run K3 and whose local triage runs the encoder (K1) on the card.

The port's copy of ``vainplex_openclaw_tpu/cortex/``, module for module
under the same names, kept here so the port imports nothing of the JAX
package. The deviations are named in ``plugin.py``, ``patterns.py``,
``llm_enhance.py``, ``pre_compaction.py`` and ``trace_analyzer/analyzer.py``.
"""

from .plugin import CortexPlugin
from .trace_analyzer import MemoryTraceSource, TraceAnalyzer
from .trace_analyzer.analyzer import register_trace_analyzer

__all__ = ["CortexPlugin", "MemoryTraceSource", "TraceAnalyzer",
           "register_trace_analyzer"]
