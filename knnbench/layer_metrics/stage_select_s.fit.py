"""Orchestrator (annchor.py, Annchor.fit): seconds of the
select_refine_candidate_pairs stage, where the budget's refine
evaluations are spent, summed over the iterations of a fit, from the
fit's own stage table (synchronised at each stage), averaged over the
traced run's stage-table fits."""


def read(records):
    tables = records.get("stage_tables") or []
    if not tables:
        return None
    return sum(sum(s for n, s in t if n == "select_refine_candidate_pairs")
               for t in tables) / len(tables)
