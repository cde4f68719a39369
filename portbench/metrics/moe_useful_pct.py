"""Percent of the MoE experts' work that the router asked for: the
port's counter ``moe.pairs_routed`` (tokens × top_k) over
``moe.pairs_computed`` (tokens × the experts run on each), both counted
at each MoE layer's forward while the traced window was profiled."""


def read(rec):
    if rec.trace is None:
        return None
    try:
        from repro_torch.utils import spans
    except ImportError:        # a program with no counters
        return None
    counts = spans.counters()
    computed = counts.get("moe.pairs_computed", 0)
    if not computed:
        return None
    return 100.0 * counts.get("moe.pairs_routed", 0) / computed
