"""The second pass's share of its roofline: the least time its work needs
at the published H100 peaks (``pass_work.second_pass_work``), a mean over
the traced calls, over the device time launched inside the
``rerank.second_pass`` stage a counted call (``portbench/stages.py``).
None without a device trace or without the stage."""
from portbench import pass_work, roofline, stages

STAGE = "rerank.second_pass"


def read(ctx):
    st, tr = stages.read(ctx), ctx.profile
    if st is None or not st.calls or tr is None or not tr.n_calls:
        return None
    seconds = st.device_us.get(STAGE, 0.0) * 1e-6 / st.calls
    if seconds <= 0:
        return None
    recs = ctx.window.traced[-tr.n_calls:]
    d = ctx.engine.index.vectors.shape[1]
    need = sum(roofline.bound(*pass_work.second_pass_work(
        d, *pass_work.second_pass_counts(rec.result)))[0] for rec in recs)
    return 100.0 * need / len(recs) / seconds
