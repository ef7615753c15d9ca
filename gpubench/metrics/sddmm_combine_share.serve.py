"""sddmm_combine_share.serve: the device seconds of the SDDMM combine
(``apply.combine`` spans with ``op="sddmm"``) over those of the whole
``GNNService`` flushes (``gnn_service.flush`` spans), in the traced
slice, in percent.

The program's process tracer records spans, each on the card's stream
between two CUDA events, while the profiler records: exactly the
slice. None where the slice holds no such combine, or the program
records no spans on the device clock."""

KIND, NUM, OP, DEN = "serve", "apply.combine", "sddmm", "gnn_service.flush"


def read(rec):
    if rec.mix["kind"] != KIND or not rec.trace:
        return None
    from repro_torch.obs.trace import get_tracer

    num = den = 0.0
    todo = list(get_tracer().roots)
    while todo:
        sp = todo.pop()
        todo.extend(sp.children)
        dev = getattr(sp, "device_s", None)
        if dev is None:
            continue
        if sp.name == DEN:
            den += dev
        elif sp.name == NUM and sp.attrs.get("op") == OP:
            num += dev
    return 100.0 * num / den if num > 0 and den > 0 else None
