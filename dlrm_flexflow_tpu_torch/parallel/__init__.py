"""Placement across ranks: the per-op parallel configs, the strategy
files, the mesh over ranks, degrees to mesh axes, and the process group
(``torch.distributed``)."""
