"""Fact embeddings for the knowledge engine on the port's encoder."""
