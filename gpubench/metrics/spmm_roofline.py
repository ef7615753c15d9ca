"""spmm_roofline: the bound of one ``GraphOps.spmm`` forward at
n = 256 on the cell's plans (``gpubench.work``) over its device time,
in percent. The time is the whole apply (kernels, combine,
revaluation, permutes), 20 applies back to back between CUDA events,
queued behind a device sleep so the host's launches do not show."""
from gpubench import opclock, work

N = 256


def read(rec):
    gops = getattr(rec.world, "gops", None)
    if gops is None or rec.dev.type != "cuda":
        return None
    import torch

    g = rec.world.graph
    gen = torch.Generator(device=rec.dev).manual_seed(256)
    vals = torch.randn(g.nnz, generator=gen, device=rec.dev)
    b = torch.randn(g.k, N, generator=gen, device=rec.dev)
    seconds = opclock.device_seconds(lambda: gops.spmm(vals, b))
    return 100.0 * work.bound_s(*work.spmm_work(g.m, g.k, g.nnz, N)) / seconds
