"""The detection data path: datasets, augmentation, processing and the
loader (numpy on the host); import the submodules directly."""
