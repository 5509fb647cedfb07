"""recall (fraction): mean recall@k over every query the window served,
against the reference's exact top-k (k is the cell's)."""


def read(run):
    return run.recall
