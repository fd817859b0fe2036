"""Seconds a job spends in the app's per-level exports (`make_callback`'s
own `exports` seconds), averaged over the jobs that exported."""


def read(ctx):
    v = [j.exports["exports"] for j in ctx.jobs if j.exports and "exports" in j.exports]
    return sum(v) / len(v) if v else None
