"""Attention dispatch (``repro_torch.dist.flash``), single device."""
