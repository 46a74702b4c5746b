"""parallel.rank_imbalance: the slowest rank's own time in its calls
over the mean rank's, each rank on its own host clock (from a call's
start to the service's return, before the wait at the all-reduce),
gathered by one all-reduce after the window."""


def read(out):
    own = out.extra.get("rank_own_s")
    if not own or min(own) <= 0:
        return None
    return max(own) / (sum(own) / len(own))
