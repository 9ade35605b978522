"""The runtime check of a partition-rule table against real parameter paths.

A copy of ``validate_rule_table`` from the JAX package's
``analysis/sharding.py`` (which imports no jax, but lives in that package);
``tests/test_torch_mesh_families.py`` pins the two equal on every plan
table of both packages and the parameter paths of the dense and MoE
configurations.
"""

from __future__ import annotations

import re


def validate_rule_table(rules, paths, regex: bool = False) -> list:
    """Problems with ``rules`` ((pattern, spec), …) over ``paths``: every
    rule must win (be the first match) on at least one path. Returns
    human-readable problem strings; empty means every rule is live.
    ``regex=True`` matches with ``re.search``, else by substring."""
    problems = []
    hit = [False] * len(rules)

    def matches(pat, path):
        return bool(re.search(pat, path)) if regex else pat in path

    for path in paths:
        for i, (pat, _spec) in enumerate(rules):
            if matches(pat, path):
                hit[i] = True
                break
    for i, ((pat, _spec), won) in enumerate(zip(rules, hit)):
        if not won:
            if any(matches(pat, p) for p in paths):
                problems.append(
                    f"rule {i} ({pat!r}) matches paths but never wins — "
                    f"shadowed by an earlier rule on every match")
            else:
                problems.append(
                    f"rule {i} ({pat!r}) matches zero param paths — dead "
                    f"rule (typo, or params renamed)")
    return problems
