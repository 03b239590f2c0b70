"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``kernels.morph_matmul`` — width-gated projection (``csrc/morph_matmul.cu``).
* ``kernels.fused_decode`` — one attention layer of one-token decode
  (``csrc/fused_decode.cu`` plus the morph_matmul kernel).

The submodules are not re-exported here: a function named like its module
would shadow the module. ``flash_attention``, ``flash_decode`` and
``ssd_scan`` are not on this slice's path and are still to be ported.
"""
