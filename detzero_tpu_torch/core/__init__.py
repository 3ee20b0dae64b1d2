"""Optimizers and schedules; import the submodules directly."""
