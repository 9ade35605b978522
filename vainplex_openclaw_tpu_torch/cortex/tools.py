"""Read-only agent tools (reference: cortex/src/tools/ — 5 tools, opt-in,
<100 ms budget; they read the trackers' JSON files, never mutate).

A copy of ``vainplex_openclaw_tpu/cortex/tools.py``."""

from __future__ import annotations


from .storage import journal_barrier, load_json, reboot_dir


def _threads(workspace) -> list[dict]:
    journal_barrier(workspace)
    data = load_json(reboot_dir(workspace) / "threads.json")
    if isinstance(data, list):
        return data
    return data.get("threads") or []


def _decisions(workspace) -> list[dict]:
    journal_barrier(workspace)
    return load_json(reboot_dir(workspace) / "decisions.json").get("decisions") or []


def _commitments(workspace) -> list[dict]:
    journal_barrier(workspace)
    return load_json(reboot_dir(workspace) / "commitments.json").get("commitments") or []


def _matches(query: str, *fields: str) -> bool:
    q = query.lower()
    return any(q in (f or "").lower() for f in fields)


def cortex_threads(workspace, params: dict) -> dict:
    status = params.get("status", "open")
    threads = [t for t in _threads(workspace) if status in ("all", t.get("status"))]
    return {"threads": [{"title": t["title"], "status": t["status"],
                         "priority": t.get("priority"), "waiting_for": t.get("waiting_for"),
                         "decisions": t.get("decisions", [])} for t in threads]}


def cortex_decisions(workspace, params: dict) -> dict:
    limit = int(params.get("limit", 10))
    return {"decisions": [{"what": d["what"], "why": d.get("why"),
                           "impact": d.get("impact"), "date": d.get("date")}
                          for d in _decisions(workspace)[-limit:]]}


def cortex_commitments(workspace, params: dict) -> dict:
    wanted = params.get("status", "open")
    items = [c for c in _commitments(workspace)
             if wanted == "all" or c.get("status") == wanted
             or (wanted == "open" and c.get("status") == "overdue")]
    return {"commitments": [{"what": c["what"], "status": c["status"],
                             "created": c.get("created")} for c in items]}


def cortex_search(workspace, params: dict) -> dict:
    """Cross-search threads, decisions, and commitments."""
    query = params.get("query", "")
    if not query:
        return {"results": []}
    results = []
    for t in _threads(workspace):
        if _matches(query, t.get("title"), t.get("summary"), *t.get("decisions", [])):
            results.append({"kind": "thread", "title": t["title"], "status": t["status"]})
    for d in _decisions(workspace):
        if _matches(query, d.get("what"), d.get("why")):
            results.append({"kind": "decision", "what": d["what"], "date": d.get("date")})
    for c in _commitments(workspace):
        if _matches(query, c.get("what")):
            results.append({"kind": "commitment", "what": c["what"], "status": c["status"]})
    return {"results": results[: int(params.get("limit", 20))]}


def cortex_status(workspace, params: dict) -> dict:
    threads = _threads(workspace)
    return {
        "threads_open": sum(1 for t in threads if t.get("status") == "open"),
        "threads_closed": sum(1 for t in threads if t.get("status") == "closed"),
        "decisions": len(_decisions(workspace)),
        "commitments_open": sum(1 for c in _commitments(workspace)
                                if c.get("status") in ("open", "overdue")),
    }


def register_cortex_tools(api, workspace_resolver) -> None:
    """``workspace_resolver(ctx_or_params)`` resolves the calling workspace at
    invocation time — tools must not be frozen onto the default workspace in
    multi-workspace gateways."""

    def make_handler(fn):
        def handler(params):
            params = params or {}
            workspace = workspace_resolver(params)
            return fn(workspace, params)

        return handler

    for name, fn, desc in (
        ("cortex_threads", cortex_threads, "List conversation threads"),
        ("cortex_decisions", cortex_decisions, "List recent decisions"),
        ("cortex_search", cortex_search, "Search threads/decisions/commitments"),
        ("cortex_commitments", cortex_commitments, "List open commitments"),
        ("cortex_status", cortex_status, "Tracker counters"),
    ):
        api.register_tool({
            "name": name, "description": desc, "readonly": True,
            "handler": make_handler(fn),
        })
