"""Tensor ops and kernel wrappers; import the submodules directly."""
