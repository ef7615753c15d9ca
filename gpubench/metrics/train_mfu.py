"""train_mfu: the model's FLOPs a step (its kind's ``step_flops``,
counted by ``gpubench.work``'s rule) over the step time of the traced
run's steps before the profiled slice, as a share of the H100's dense
TF32 peak, in percent."""
from gpubench import cells, work


def read(rec):
    pre = rec.window.get("pre")
    if rec.mix["kind"] != "train" or not pre or pre[1] == 0:
        return None
    seconds, steps = pre
    g = rec.world.graph
    flops = cells.model_kind(rec.cfg).step_flops(g.m, g.nnz, rec.cfg)
    return 100.0 * flops / (seconds / steps) / work.PEAK_TF32_FLOPS
