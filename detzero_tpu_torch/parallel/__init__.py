"""The training step; import the submodules directly."""
