"""The cortex consumers of the encoder: on-device trace-finding triage."""
