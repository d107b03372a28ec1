"""Instance generators, one file each, found by the name a configuration's
``generator`` gives.  Each module defines ``generate(seed, **args) ->
sdpbench.sdpa.SDPData``.  They import numpy only."""
