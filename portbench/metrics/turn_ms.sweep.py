"""The untraced sweeps' mean wall less the packer's, over the turns each
sweep dispatched (``hotloop.KEY_LOG``): the hot loop's ms a turn."""


def read(run):
    walls = run.spans.get("sweep")
    pack = run.spans.get("pack")
    turns = run.counters.get("turns_per_sweep")
    if not walls or not pack or not turns:
        return None
    return 1e3 * (sum(walls) / len(walls) - pack[0]) / turns
