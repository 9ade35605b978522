"""The agent firewall (reference: packages/openclaw-governance).

Policy-based enforcement over the gateway hooks: condition evaluation, risk
assessment, persistent agent trust + ephemeral session trust, cross-agent
trust ceilings, buffered audit trail, plus (in submodules) output
validation and the response gate.

A copy of ``vainplex_openclaw_tpu/governance/``, module for module under the
same names, kept here so the port imports nothing of the JAX package. The
config-only local stage 3 (``validation.llmValidator: {enabled: true,
local: true}``) serves its verdicts from the port's encoder on the card, or
on the device ``GovernancePlugin(device=...)`` names; ``redaction/`` runs
its outbound scan before governance enforces, so stage 3 scores the
redacted text. ``approval/`` (2FA, with the Matrix notifier and poller) and
``security/`` (ERC-8004, AgentProof) are built from the config as in the
JAX package.

On the stage-3 path the JAX package turns every error into a verdict or a
log line. The port lets an error of the device (``device.is_device_error``)
propagate at each of those places and keeps the JAX behaviour for every
other error:

- the hook bus (``core/api.py``);
- ``GovernancePlugin._fail``, the handlers' failMode result (``plugin.py``);
- ``GovernancePlugin._init_validation``, which builds the local stage 3
  (``plugin.py``);
- ``OutputValidator.validate``'s stage-3 catch
  (``validation/output_validator.py``);
- ``LlmValidator.validate``'s retry (``validation/llm_validator.py``).
"""

from .engine import GovernanceEngine
from .plugin import GovernancePlugin

__all__ = ["GovernanceEngine", "GovernancePlugin"]
