"""Host-side pipeline stages (the Waymo-protocol evaluator, the daemon
between tracking and refining); import the submodules directly."""
