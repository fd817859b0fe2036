"""Seconds a job spends in keyframe selection and fusion (host clock, the
card synchronized after fusion; traced runs), averaged over the jobs."""


def read(ctx):
    v = [j.kf_fusion_s for j in ctx.jobs if j.kf_fusion_s is not None]
    return sum(v) / len(v) if v else None
