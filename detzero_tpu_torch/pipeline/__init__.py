"""Host-side pipeline stages (the Waymo-protocol evaluator); import the
submodules directly."""
