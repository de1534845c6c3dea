"""What the program recorded in a traced window, for the readers of its
spans and counters (metrics/lq.*, kmer.device_query_share,
orchestrator.unstaged_s_per_Mbp).

The program's recorder, nextpolish2_tpu_torch/utils/timing.py, keeps each
span as (name, thread, start, end, parent, contig) on time.time() and a
count per counter name. run.py reads the per-layer metrics right after the
window, when the probes have turned the recorder off without clearing it,
so it still holds the window alone (turning it on cleared it). A reader
gets ctx["program"] where the caller passes one ({"spans", "counters"}),
else the recorder as it stands; None where the program has no recorder.
"""

from __future__ import annotations


def recording(ctx):
    prog = ctx.get("program")
    if prog is not None:
        return prog
    from nextpolish2_tpu_torch.utils import timing

    if not hasattr(timing, "spans"):  # a program without the recorder
        return None
    return {"spans": timing.spans(), "counters": timing.counters()}
