"""Knowledge engine (reference: packages/openclaw-knowledge-engine).

The port's copy of ``vainplex_openclaw_tpu/knowledge/``: regex NER over
conversation messages → canonical entities; a subject-predicate-object
fact store with relevance decay; optional LLM fact extraction; embeddings
sync (ChromaDB-shaped HTTP, or the local index on the port's encoder, on
the card by default); maintenance timers.
"""

from .plugin import KnowledgeEnginePlugin

__all__ = ["KnowledgeEnginePlugin"]
