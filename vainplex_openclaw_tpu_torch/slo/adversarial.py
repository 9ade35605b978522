"""The sitrep's reader of the adversarial-run state file.

A copy of ``read_adversarial_state`` from
``vainplex_openclaw_tpu/slo/adversarial.py``, kept here so the port's
sitrep imports nothing of the JAX package. It reads the file the JAX
package's adversarial runner writes (``stateFile``, default
``.adversarial.json`` in the workspace); the attack packs and their runner
are not ported yet.
"""

from __future__ import annotations

from pathlib import Path

from ..storage.atomic import read_json

_STATE_FILE = ".adversarial.json"


def read_adversarial_state(workspace, config: dict = None):
    """The last adversarial run's state dict from ``workspace``, or None."""
    name = (config or {}).get("stateFile", _STATE_FILE)
    data = read_json(Path(workspace) / str(name), None)
    return data if isinstance(data, dict) else None
