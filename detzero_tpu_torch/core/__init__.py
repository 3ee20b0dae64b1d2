"""Config, logging, registries, optimizers and checkpoints; import the
submodules directly."""
