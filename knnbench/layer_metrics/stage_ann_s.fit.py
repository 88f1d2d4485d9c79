"""Orchestrator (annchor.py, Annchor.fit): seconds of the get_ann stage
(the graph's assembly and, in a hybrid, the exact certify), from the
fit's own stage table, averaged over the traced run's stage-table fits."""


def read(records):
    tables = [t for t in records.get("stage_tables") or [] if any(n == "get_ann" for n, _ in t)]
    if not tables:
        return None
    return sum(sum(s for n, s in t if n == "get_ann") for t in tables) / len(tables)
