"""Pages the compactor relocated verbatim over all pages it wrote
(tempodb_compaction_pages_copied_verbatim_total over it plus
tempodb_compaction_pages_reencoded_total), as a delta over the window."""

from benchmark import layerstats as _c


def read(ctx):
    v = _c.delta(ctx, "compaction", "verbatim")
    r = _c.delta(ctx, "compaction", "reencoded")
    return 100.0 * v / (v + r) if v + r > 0 else None
