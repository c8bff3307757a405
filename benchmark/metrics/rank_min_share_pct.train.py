"""rank_min_share_pct.train: the slowest rank's images/s as a share of
the mean rank's, from the ranks' own counts over their windows."""


def read(ctx):
    if ctx["role"] != "train" or len(ctx["ranks"]) < 2:
        return None
    rates = [r["images"] / r["wall_s"] for r in ctx["ranks"]]
    return 100.0 * min(rates) / (sum(rates) / len(rates))
