"""Stage-2 triage and classification of trace-analyzer findings on the
port's encoder."""
