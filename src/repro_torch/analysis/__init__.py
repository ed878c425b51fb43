"""Counting and modelling tools: the dry run's operation counts
(:mod:`~repro_torch.analysis.op_stats`), the three-term roofline
(:mod:`~repro_torch.analysis.roofline`) and its tables
(:mod:`~repro_torch.analysis.report`)."""
