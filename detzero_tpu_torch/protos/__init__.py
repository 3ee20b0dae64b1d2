"""The Waymo schemas that preprocessing reads and the submission writer
writes (port of detzero_tpu/protos: the same message names, field numbers
and enum values), on the package's own wire codec (`wire.py`) instead of
`google.protobuf`; import the submodules directly."""
