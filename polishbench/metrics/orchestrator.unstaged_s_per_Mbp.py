"""Seconds of the passes that no stage covers, per Mbp
(pipeline/orchestrator.py): the time of the program's `pass` spans (one
orchestrator.polish call each) outside the union of every other span on
any thread, `contig` spans excepted: the contig loop, FASTA read and
emit, the lookahead hand-off, and whatever else no stage names."""

from polishbench.program import recording

LAYER = "orchestrator"
UNIT = "s/Mbp"
MOVES = "polish_rate"
NOT_COVER = ("pass", "contig")


def read(ctx):
    prog = recording(ctx)
    if not prog or ctx["bases"] <= 0:
        return None
    passes = [(r[2], r[3]) for r in prog["spans"]
              if r[0] == "pass" and r[3] is not None]
    if not passes:
        return None
    cover = sorted((r[2], r[3]) for r in prog["spans"]
                   if r[0] not in NOT_COVER and r[3] is not None)
    merged = []
    for s, e in cover:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    unstaged = 0.0
    for p0, p1 in passes:
        covered = sum(max(0.0, min(e, p1) - max(s, p0)) for s, e in merged)
        unstaged += p1 - p0 - covered
    return unstaged / (ctx["bases"] / 1e6)
