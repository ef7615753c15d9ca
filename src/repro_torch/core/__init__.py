"""Algorithm layer: windows, distribution, balancing, preprocessing and
the public operators (:mod:`repro_torch.core.spmm`,
:mod:`repro_torch.core.sddmm`)."""
