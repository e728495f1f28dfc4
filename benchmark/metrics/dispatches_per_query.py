"""Device dispatches a query_range: the responses' deviceDispatches summed
over the window's answered requests, over their number."""


def read(ctx):
    ok = [r for r in ctx["records"] if r["status"] == 200]
    if not ok:
        return None
    total = sum(int(((r["doc"] or {}).get("metrics") or {}).get("deviceDispatches", 0) or 0)
                for r in ok)
    return total / len(ok)
