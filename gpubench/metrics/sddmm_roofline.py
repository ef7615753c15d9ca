"""sddmm_roofline: the bound of one ``GraphOps.sddmm`` forward at
kf = 256 on the cell's plans (``gpubench.work``) over its device time,
in percent; the whole apply (kernels, combine, the padding slot), timed
as ``spmm_roofline`` is."""
from gpubench import opclock, work

KF = 256


def read(rec):
    gops = getattr(rec.world, "gops", None)
    if gops is None or rec.dev.type != "cuda":
        return None
    import torch

    g = rec.world.graph
    gen = torch.Generator(device=rec.dev).manual_seed(257)
    x = torch.randn(g.m, KF, generator=gen, device=rec.dev)
    y = torch.randn(g.k, KF, generator=gen, device=rec.dev)
    seconds = opclock.device_seconds(lambda: gops.sddmm(x, y))
    return 100.0 * work.bound_s(*work.sddmm_work(g.m, g.k, g.nnz, KF)) / seconds
