"""Stage-2 triage of trace-analyzer findings on the port's encoder."""
