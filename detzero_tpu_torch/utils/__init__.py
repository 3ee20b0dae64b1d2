"""Host-side utilities (the HTML sequence viewer); import the submodules
directly."""
